"""Worker for the two-process multi-host test (tests/test_multihost.py).

Usage: python tools/multihost_worker.py <process_id> <port> <out_npz>

Each process contributes 4 fake CPU devices (8 global); the pair forms a
jax.distributed cluster on localhost, builds the global ray mesh, renders
a tiny Cornell frame through the production sharded wavefront, and
process 0 writes the gathered image + metadata. This exercises the real
multi-controller path (parallel/distributed.py): global mesh spanning
processes, replicated scene, per-process pixel slices, cross-process
collectives (the rays psum crosses processes).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
proc_id = int(sys.argv[1])
port = sys.argv[2]
out = sys.argv[3]

# backends initialize lazily, so platform/device-count config applies
# when set before first use.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
import jax

jax.config.update("jax_platforms", "cpu")

from pathtrace_tpu.parallel import distributed

distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                       num_processes=2, process_id=proc_id)
info = distributed.process_info()
assert info["process_count"] == 2, info
assert info["global_devices"] == 8, info

import numpy as np
import jax.numpy as jnp
from jax.experimental import multihost_utils

from pathtrace_tpu.models import procedural
from pathtrace_tpu.parallel.mesh import render_wavefront_sharded
from pathtrace_tpu.integrator.config import IntegratorConfig
from pathtrace_tpu.utils import rng

mesh = distributed.global_ray_mesh()
assert mesh.devices.size == 8

scene = procedural.cornell_box_scene().with_mt()
cam = procedural.default_camera(16, 16)
film, rays = render_wavefront_sharded(scene, cam, 4, rng.make_key(3),
                                      mesh, IntegratorConfig(), lanes=512)
img = multihost_utils.process_allgather(film, tiled=True)
# rays is replicated (psum over the global mesh): read the local replica
rays_val = float(np.asarray(rays.addressable_data(0)))
if proc_id == 0:
    np.savez(out, img=np.asarray(img), rays=rays_val,
             process_count=info["process_count"],
             global_devices=info["global_devices"])
print(f"[worker {proc_id}] done", flush=True)
