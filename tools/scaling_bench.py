"""Scaling harness: weak + strong sweeps over a device mesh.

  - WEAK scaling (default): per-device work is FIXED (each device owns
    the same pixel slice size and lane pool; the image grows with n).
    Perfect scaling on real hardware = flat per-device wall time. On the
    fake CPU mesh the devices share one socket, so total compute still
    grows with n and per-device time degrades ~linearly regardless of
    sharding quality - the CPU run validates the HARNESS, not the
    metric.
  - STRONG scaling (SCALE_MODE=strong): fixed total work split n ways -
    meaningful only on real multi-device hardware.

    python tools/scaling_bench.py                 # weak, CPU fake mesh
    env SCALE_MODE=strong python ...              # strong sweep
    env SCALE_PLATFORM=gpu python ...             # on real GPUs

Writes docs/scaling_bench.json.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("SCALE_PLATFORM", "cpu") == "cpu":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
import jax

if os.environ.get("SCALE_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from pathtrace_tpu.models import procedural
from pathtrace_tpu.parallel.mesh import (make_ray_mesh,
                                         render_wavefront_sharded)
from pathtrace_tpu.integrator.config import IntegratorConfig
from pathtrace_tpu.utils import rng

MODE = os.environ.get("SCALE_MODE", "weak")
W = H = int(os.environ.get("SCALE_SIDE", 64))   # per-device tile (weak)
SPP = int(os.environ.get("SCALE_SPP", 8))
LANES = int(os.environ.get("SCALE_LANES", 4096))  # per device (weak)

on_cpu = jax.devices()[0].platform == "cpu"
scene = procedural.cornell_box_scene(include_spheres=True).with_mt()
scene = scene.to_device()
cfg = IntegratorConfig()
key = rng.make_key(0)

n_avail = len(jax.devices())
sizes = [n for n in (1, 2, 4, 8) if n <= n_avail]
rows = []
for n in sizes:
    mesh = make_ray_mesh(n)
    if MODE == "weak":
        # image height grows with n: contiguous pixel slices = one
        # (W x H) tile per device; lanes scale with n so per-device pools
        # stay LANES
        cam = procedural.default_camera(W, H * n)
        lanes = LANES * n
    else:
        cam = procedural.default_camera(W, H)
        lanes = LANES
    run = lambda s: render_wavefront_sharded(
        scene, cam, s, key, mesh, cfg, lanes=lanes)
    img, nrays = run(2)
    jax.block_until_ready(img)
    t0 = time.perf_counter()
    img, nrays = run(SPP)
    jax.block_until_ready(img)
    dt = time.perf_counter() - t0
    rays = float(np.asarray(nrays))
    rows.append({"n_devices": n, "seconds": round(dt, 4),
                 "rays_per_sec": round(rays / dt, 1),
                 "rays_per_sec_per_device": round(rays / dt / n, 1)})
    print(rows[-1], flush=True)

base = rows[0]["rays_per_sec_per_device"]
for r in rows:
    # weak scaling: perfect = flat rays/s/chip; strong: same formula
    # (rays grow with n under weak, stay fixed under strong)
    r["efficiency_vs_1"] = round(r["rays_per_sec_per_device"] / base, 4)

out = {
    "engine": "wavefront",
    "mode": MODE,
    "platform": jax.devices()[0].platform,
    "note": ("weak scaling on the fake CPU mesh: per-device WORK is "
             "fixed but the fake devices share one host socket, so "
             "total compute still grows with n and per-device time "
             "degrades ~linearly; re-run on real devices for the metric"
             if on_cpu else "device sweep"),
    "device_kind": jax.devices()[0].device_kind,
    "config": {"per_device_side": [W, H], "spp": SPP,
               "per_device_lanes": LANES},
    "rows": rows,
}
os.makedirs("docs", exist_ok=True)
with open("docs/scaling_bench.json", "w") as f:
    json.dump(out, f, indent=2)
print(json.dumps({"rows": len(rows), "mode": MODE,
                  "platform": out["platform"]}))
