"""Smoke run of the renderer on NVIDIA GPUs, through its normal entry points.

    python chip_smoke.py            # every phase below, on one card
    python chip_smoke.py --four     # the sharded path: 4 cards vs 1

Phases (one card): card and devices; the pair-block kernel against the
plain search and the brute-force oracle on real blob82k batches; renders
against the committed CPU goldens; the full-size frames, timed; the
gradient trainer; the CLI. Each result line carries the card's name and
power limit. The last line is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}, printed only when
every phase passed. Without a GPU, or when a phase fails, the script
exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
# sizes (the CPU rehearsal of this script shrinks them)
MESH_LANES = 49152             # blob82k wavefront width
FRAME_SIDE = 256
FRAME_SPP = {"cornell": 1024, "glass": 1024, "mesh": 64}
TRAIN_SIDE, TRAIN_SPP = 128, 64
FOUR_SIDE, FOUR_SPP, FOUR_TRAIN_SPP = 1024, 4, 16
FOUR_LANES, TRAIN_LANES = 65536, 16384
CARD = "not read"
FAILED: list[str] = []


def card_line() -> str:
    """nvidia-smi's name and power limit, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line)


def report(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "card": CARD},
                     default=float), flush=True)


def check(phase: str, name: str, ok: bool, **fields) -> bool:
    report(phase, check=name, ok=bool(ok), **fields)
    if not ok:
        FAILED.append(f"{phase}/{name}")
    return bool(ok)


def agreement(img, ref):
    import numpy as np
    img, ref = np.asarray(img), np.asarray(ref)
    close = np.isclose(img, ref, rtol=5e-3, atol=5e-3)
    return (float(close.mean()),
            float(abs(img.mean() - ref.mean()) / abs(ref.mean())))


def max_rel_err(a, b) -> float:
    """max over pytree leaves of max|a-b| / max|a| (scale floor 1e-6)."""
    import jax
    import numpy as np
    errs = [float(np.abs(np.asarray(x) - np.asarray(y)).max()
                  / max(float(np.abs(np.asarray(x)).max()), 1e-6))
            for x, y in zip(jax.tree_util.tree_leaves(a),
                            jax.tree_util.tree_leaves(b))]
    return max(errs)


# ---------------------------------------------------------------- phases

def phase_kernel(blob):
    """Pair-block kernel vs the plain search (same slots) and vs the
    brute-force MT search (per ray) on a camera and a bounce batch."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pathtrace_tpu.accel import binned
    from pathtrace_tpu.integrator.wavefront import _regen_rays
    from pathtrace_tpu.models import procedural
    from pathtrace_tpu.ops.mt_matmul import mt_closest_auto
    from pathtrace_tpu.ops.pallas import pair_kernel as pk
    from pathtrace_tpu.utils import math3, rng

    r, b = MESH_LANES, binned.BLOCK_PAIRS
    cl = blob.clusters
    key = rng.make_key(0)
    cam = procedural.default_camera(FRAME_SIDE, FRAME_SIDE)
    org, d, _ = _regen_rays(cam, jnp.arange(r, dtype=jnp.int32), key,
                            FRAME_SIDE * FRAME_SIDE)
    tmin = jnp.zeros((r,), jnp.float32)
    tmax = jnp.full((r,), 999999.0, jnp.float32)
    brute = jax.jit(mt_closest_auto)
    hit, t, idx, _, _ = brute(blob.mt, org, d, tmin, tmax)
    # bounce batch: cosine-ish directions about the hit's geometric normal
    n = jnp.asarray(blob.tris.geometric_normal)[idx]
    n = jnp.where(jnp.sum(n * d, axis=1, keepdims=True) > 0, -n, n)
    g = jax.random.normal(jax.random.PRNGKey(1), (r, 3))
    bd = math3.normalize(n + math3.normalize(g))
    bo = org + t[:, None] * d + math3.EPS * n
    bounce_org = jnp.where(hit[:, None], bo, org)
    bounce_dir = jnp.where(hit[:, None], bd, math3.normalize(g))

    inputs = jax.jit(lambda o, dd: binned.pair_inputs_v3(
        cl, o, dd, tmin, tmax, b))
    coeffs = jnp.asarray(cl.coeffs)
    kern = jax.jit(lambda *a: pk.pair_search_kernel(*a, block_pairs=b))
    plain = jax.jit(lambda *a: pk.pair_search_plain(*a, block_pairs=b))

    def per_ray(t_slot, member, disp):
        live = disp["live"]
        t_slot = jnp.where(live, t_slot, jnp.inf)
        best = jnp.full((r,), jnp.inf).at[disp["slot_ray"]].min(t_slot)
        cap = t_slot.shape[0]
        win = (t_slot == best[disp["slot_ray"]]) & jnp.isfinite(t_slot)
        pos = jnp.full((r,), cap, jnp.int32).at[disp["slot_ray"]].min(
            jnp.where(win, jnp.arange(cap, dtype=jnp.int32), cap))
        mem = (disp["block_prim_start"][:, None]
               + member.reshape(-1, b)).reshape(-1)
        gid = jnp.asarray(cl.dup_map)[jnp.clip(mem, 0)]
        return jnp.isfinite(best), best, gid[jnp.minimum(pos, cap - 1)]

    def compare(a, bb, mask):
        ha, ta, ia = (np.asarray(x)[mask] for x in a)
        hb, tb, ib = (np.asarray(x)[mask] for x in bb)
        agree = ha == hb
        both = ha & hb
        t_ok = np.allclose(ta[both], tb[both], rtol=1e-4, atol=1e-3)
        return (float(agree.mean()), t_ok,
                float((ia[both] == ib[both]).mean()))

    report("kernel", precision=str(pk.PRECISION), dot="IEEE f32",
           block_pairs=b, chunk=pk.CHUNK, num_warps=pk.NUM_WARPS,
           cells=cl.num_clusters, cell_cap=cl.cluster_cap, lanes=r)
    for name, (o, dd) in (("camera", (org, d)),
                          ("bounce", (bounce_org, bounce_dir))):
        disp, f, tn, tx = inputs(o, dd)
        args = (coeffs, disp["block_cluster"], disp["block_count"], f, tn,
                tx)
        if name == "camera":
            mem = pk.pair_search_kernel.lower(
                *args, block_pairs=b).compile().memory_analysis()
            report("kernel", memory_analysis=str(mem))
        times = {}
        for label, fn in (("kernel", kern), ("plain", plain)):
            out = fn(*args)
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            for _ in range(10):
                out = fn(*args)
            jax.block_until_ready(out)
            times[label] = (time.perf_counter() - t0) / 10
            if label == "kernel":
                k_out = out
            else:
                p_out = out
        rk = per_ray(*k_out, disp)
        rp = per_ray(*p_out, disp)
        rb = brute(blob.mt, o, dd, tmin, tmax)[:3]
        ok_rays = ~np.asarray(disp["overflow"])
        every = np.ones((r,), bool)
        for ref_name, ref, mask in (("plain", rp, every),
                                    ("brute", rb, ok_rays)):
            hit_agree, t_ok, id_agree = compare(ref, rk, mask)
            check("kernel", f"{name}_vs_{ref_name}",
                  hit_agree >= 0.995 and t_ok and id_agree >= 0.995,
                  hit_agreement=hit_agree, t_within_tol=t_ok,
                  id_agreement=id_agree, rays=int(mask.sum()))
        report("kernel", batch=name, kernel_ms=times["kernel"] * 1e3,
               plain_ms=times["plain"] * 1e3,
               live_slots=int(np.asarray(disp["live"]).sum()),
               slots=int(disp["live"].shape[0]),
               overflow_rays=int((~ok_rays).sum()))


def phase_goldens(blob):
    """Renders against the committed CPU goldens (tests/test_golden.py's
    thresholds, except glass: see below)."""
    import numpy as np
    from pathtrace_tpu import render
    from pathtrace_tpu.integrator.wavefront import render_wavefront
    from pathtrace_tpu.models import procedural
    from pathtrace_tpu.utils import rng

    cornell = procedural.cornell_box_scene().with_mt().to_device()
    glass = procedural.glass_scene().with_mt().to_device()
    glass_brute = procedural.glass_scene().to_device()   # as the golden
    cam32 = procedural.default_camera(32, 32)
    cam24 = procedural.default_camera(24, 24)
    cam48 = procedural.default_camera(48, 48)
    runs = [
        ("cornell_megakernel",
         lambda: render(cornell, cam32, 8, rng.make_key(123)),
         "cornell_32x32_8spp_seed123.npy", 0.999, 1e-3),
        ("cornell_wavefront",
         lambda: render_wavefront(cornell, cam32, 8, rng.make_key(123),
                                  lanes=1024),
         "cornell_32x32_8spp_seed123.npy", 0.999, 1e-3),
        # refraction makes transport chaotic: last-bit differences
        # between two compiled programs flip whole paths. On the CPU the
        # wavefront agrees with the megakernel golden at 0.991-0.997
        # over seeds 7-14 (PERF.md); the GPU against the CPU read 0.977
        # at seed 7, with the mean within 1e-4. Small semantic changes
        # (metal roughness 0.15 -> 0.16, glass radius +1%, wall albedo
        # -1%) read 0.52-0.89, so 0.95 still separates them.
        ("glass_wavefront_seed7",
         lambda: render_wavefront(glass, cam24, 8, rng.make_key(7),
                                  lanes=576),
         "glass_24x24_8spp_seed7.npy", 0.95, 5e-3),
        ("glass_wavefront_seed8",
         lambda: render_wavefront(glass, cam24, 8, rng.make_key(8),
                                  lanes=576),
         "glass_24x24_8spp_seed8.npy", 0.95, 5e-3),
        ("glass_megakernel_seed7",
         lambda: render(glass_brute, cam24, 8, rng.make_key(7)),
         "glass_24x24_8spp_seed7.npy", 0.95, 5e-3),
        ("blob82k_wavefront_v3",
         lambda: render_wavefront(blob, cam48, 4, rng.make_key(11),
                                  lanes=2304),
         "blob82k_48x48_4spp_seed11.npy", 0.995, 1e-3),
    ]
    for name, fn, golden, min_agree, max_mean in runs:
        ref = np.load(os.path.join(GOLDEN, golden))
        agree, mean_rel = agreement(fn(), ref)
        check("goldens", name, agree > min_agree and mean_rel < max_mean,
              pixel_agreement=agree, min_agreement=min_agree,
              mean_rel_diff=mean_rel, max_mean_rel_diff=max_mean)


def phase_frames(blob):
    """The full-size frames through bench.py's timing (one timed run
    each after a compiling warm-up)."""
    import numpy as np
    import bench

    w = FRAME_SIDE
    for name, scene, lanes in (
            ("cornell", bench.build_scene("cornell"),
             bench.DEFAULT_LANES["cornell"]),
            ("glass", bench.build_scene("glass"),
             bench.DEFAULT_LANES["glass"]),
            ("mesh", blob, MESH_LANES)):
        spp = FRAME_SPP[name]
        res = bench.time_frame(scene, w, w, spp, lanes)
        img = np.asarray(res.pop("image"))
        res.pop("seconds_all")
        check("frames", f"{name}_{w}x{w}_{spp}spp",
              bool(np.isfinite(img).all() and img.mean() > 0),
              image_mean=float(img.mean()), lanes=lanes,
              peak_bytes_in_process=res.pop("peak_bytes"), **res)


def phase_trainer():
    """Wavetape training steps; wavetape vs replay and vs scan-AD."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pathtrace_tpu.diff import material_grads
    from pathtrace_tpu.integrator.config import IntegratorConfig
    from pathtrace_tpu.integrator.wavefront import render_wavefront
    from pathtrace_tpu.models import procedural
    from pathtrace_tpu.parallel import make_ray_mesh
    from pathtrace_tpu.parallel.mesh import (train_step_replay_sharded,
                                             train_step_wavetape_sharded)
    from pathtrace_tpu.utils import rng
    from pathtrace_tpu.utils.pytree import replace

    cfg = IntegratorConfig()
    mesh1 = make_ray_mesh(1)
    scene = procedural.cornell_box_scene(include_spheres=True).with_mt()
    scene = scene.to_device()
    side, spp = TRAIN_SIDE, TRAIN_SPP
    cam128 = procedural.default_camera(side, side)
    key = rng.make_key(0)
    target = render_wavefront(scene, cam128, 16, key, lanes=TRAIN_LANES)
    start = replace(scene.mat, albedo=scene.mat.albedo * 0.7)

    @jax.jit
    def three_steps(mat, tgt, k):
        def body(i, carry):
            mat, losses = carry
            loss, (g_tri, _), _ = train_step_wavetape_sharded(
                replace(scene, mat=mat), cam128, tgt, spp,
                rng.iter_key(k, i), mesh1, cfg, TRAIN_LANES, 32768)
            step = 0.01 * g_tri.albedo / (jnp.abs(g_tri.albedo).max()
                                          + 1e-12)
            mat = replace(mat, albedo=jnp.clip(mat.albedo - step, 0.0, 1.0))
            return mat, losses.at[i].set(loss)
        return jax.lax.fori_loop(0, 3, body, (mat, jnp.zeros((3,))))

    t0 = time.perf_counter()
    jax.block_until_ready(three_steps(start, target, key))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mat, losses = three_steps(start, target, rng.make_key(1))
    jax.block_until_ready(mat)
    dt = (time.perf_counter() - t0) / 3
    losses = np.asarray(losses)
    check("trainer", f"wavetape_3_steps_{side}x{side}_{spp}spp",
          bool(np.isfinite(losses).all()
               and np.isfinite(np.asarray(mat.albedo)).all()),
          losses=losses.tolist(), seconds_per_step=dt,
          paths_per_sec=side * side * spp / dt,
          first_call_seconds=compile_s)

    # one L2 loss, three backward programs (wavetape, per-sample replay,
    # scan-AD over the megakernel) realizing the same estimator:
    # agreement is float reassociation only (the CPU suite holds 1e-3,
    # test_wavetape.py)
    cam32 = procedural.default_camera(32, 32)
    tgt32 = jnp.full((32, 32, 3), 0.2)
    k = rng.make_key(3)
    lw, gw, _ = jax.jit(lambda s: train_step_wavetape_sharded(
        s, cam32, tgt32, 4, k, mesh1, cfg, 1024, 1024))(scene)
    lr_, gr, _ = jax.jit(lambda s: train_step_replay_sharded(
        s, cam32, tgt32, 4, k, mesh1, cfg))(scene)
    gs_tri, gs_sph, ls = jax.jit(lambda s: material_grads(
        s, cam32, 4, k, loss_fn=lambda img: jnp.sum((img - tgt32) ** 2),
        cfg=cfg))(scene)
    for name, loss, grads in (("replay", lr_, gr),
                              ("scan_ad", ls, (gs_tri, gs_sph))):
        err = max_rel_err(grads, gw)
        loss_rel = abs(float(lw) - float(loss)) / abs(float(loss))
        check("trainer", f"wavetape_vs_{name}_32x32_4spp",
              err < 1e-3 and loss_rel < 1e-3, max_rel_err=err,
              loss_rel_diff=loss_rel, tol=1e-3)


def phase_cli():
    """cli.main(["render", ...]) in-process, PNG + linear npy out."""
    import numpy as np
    from pathtrace_tpu import cli

    with tempfile.TemporaryDirectory() as tmp:
        for preset, extra in (("cornell64", []),
                              ("mesh512", ["--spp", "4"])):
            png = os.path.join(tmp, f"{preset}.png")
            npy = os.path.join(tmp, f"{preset}.npy")
            t0 = time.perf_counter()
            rc = cli.main(["render", "--preset", preset, "--out", png,
                           "--out-npy", npy, *extra])
            dt = time.perf_counter() - t0
            with open(png, "rb") as f:
                sig = f.read(8)
            img = np.load(npy)
            check("cli", preset, rc == 0 and sig == b"\x89PNG\r\n\x1a\n"
                  and bool(np.isfinite(img).all()) and img.mean() > 0,
                  seconds=dt, image_shape=list(img.shape),
                  image_mean=float(img.mean()),
                  png_bytes=os.path.getsize(png))


def phase_four():
    """multihost1024 (KD v3 under shard_map) and the wavetape step on a
    4-card mesh against a 1-card mesh. The four programs are traced in
    turn and compiled side by side (compilation releases the GIL), then
    each runs once to warm up and once timed."""
    import concurrent.futures

    import jax
    import jax.numpy as jnp
    import numpy as np
    from pathtrace_tpu.integrator.config import IntegratorConfig
    from pathtrace_tpu.models import procedural
    from pathtrace_tpu.models.presets import build_preset_scene, get_preset
    from pathtrace_tpu.parallel import (make_ray_mesh,
                                        render_wavefront_sharded)
    from pathtrace_tpu.parallel.mesh import train_step_wavetape_sharded
    from pathtrace_tpu.utils import rng

    assert len(jax.devices()) >= 4, jax.devices()
    cfg = IntegratorConfig()
    key = rng.make_key(0)
    scene = build_preset_scene(get_preset("multihost1024"))
    side, spp = FOUR_SIDE, FOUR_SPP
    cam = procedural.default_camera(side, side)
    tscene = procedural.cornell_box_scene(include_spheres=True).with_mt()
    tscene = tscene.to_device()
    ts, tspp = TRAIN_SIDE, FOUR_TRAIN_SPP
    cam_t = procedural.default_camera(ts, ts)
    tgt = jnp.zeros((ts, ts, 3))

    def render_fn(mesh):
        return lambda sc: render_wavefront_sharded(
            sc, cam, spp, key, mesh, lanes=FOUR_LANES)

    def train_fn(mesh):
        return lambda sc: train_step_wavetape_sharded(
            sc, cam_t, tgt, tspp, key, mesh, cfg, TRAIN_LANES, 32768)

    def compile_timed(lowered):
        t0 = time.perf_counter()
        return lowered.compile(), time.perf_counter() - t0

    jobs = {}
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        # the train steps trace and compile longest: start them first
        for kind, make, arg in (("train", train_fn, tscene),
                                ("render", render_fn, scene)):
            for n in (1, 4):
                t0 = time.perf_counter()
                lowered = jax.jit(make(make_ray_mesh(n))).lower(arg)
                jobs[kind, n] = (arg, time.perf_counter() - t0,
                                 pool.submit(compile_timed, lowered))
        outs = {}
        for (kind, n), (arg, trace_s, fut) in jobs.items():
            exe, compile_s = fut.result()
            jax.block_until_ready(exe(arg))
            t0 = time.perf_counter()
            outs[kind, n] = jax.block_until_ready(exe(arg))
            dt = time.perf_counter() - t0
            if kind == "render":
                report("four", render=f"multihost1024_{side}x{side}_{spp}spp",
                       cards=n, seconds=dt, trace_seconds=trace_s,
                       compile_seconds=compile_s,
                       paths_per_sec=side * side * spp / dt,
                       rays_per_sec=float(outs[kind, n][1]) / dt,
                       tris=scene.num_tris, lanes=FOUR_LANES)
            else:
                report("four", train_step=f"wavetape_{ts}x{ts}_{tspp}spp",
                       cards=n, seconds=dt, trace_seconds=trace_s,
                       compile_seconds=compile_s,
                       paths_per_sec=ts * ts * tspp / dt)

    # per-path RNG is keyed by global path id, so 4 cards trace the same
    # paths as 1; only film-sum order and fusion rounding differ
    agree, mean_rel = agreement(np.asarray(outs["render", 4][0]),
                                np.asarray(outs["render", 1][0]))
    check("four", "render_4_vs_1", agree > 0.999 and mean_rel < 1e-4,
          pixel_agreement=agree, mean_rel_diff=mean_rel,
          tol="rtol=atol=5e-3 on >99.9% of pixels, mean 1e-4")
    (l1, g1, _), (l4, g4, _) = outs["train", 1], outs["train", 4]
    err = max_rel_err(g1, g4)
    loss_rel = abs(float(l4) - float(l1)) / abs(float(l1))
    check("four", "train_step_4_vs_1", err < 1e-3 and loss_rel < 1e-4,
          max_rel_err=err, loss_rel_diff=loss_rel,
          tol="grads 1e-3 of max, loss 1e-4 (float reassociation)")


def main(argv=None) -> int:
    global CARD
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the 4-card sharded path and its "
                        "1-card comparison")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices}", file=sys.stderr)
        return 2
    CARD = card_line()
    print(CARD, flush=True)
    print(devices, flush=True)

    from pathtrace_tpu.utils.cache import setup_compile_cache
    print(f"compile cache: {setup_compile_cache()}", flush=True)

    if args.four:
        phases = [("four", phase_four)]
    else:
        blob = []

        def mesh_scene():
            if not blob:
                from pathtrace_tpu.models import procedural
                t0 = time.perf_counter()
                blob.append(procedural.blob_mesh_scene().with_kd_binned()
                            .to_device())
                report("setup", blob82k_build_seconds=(
                    time.perf_counter() - t0))
            return blob[0]

        phases = [
            ("kernel", lambda: phase_kernel(mesh_scene())),
            ("goldens", lambda: phase_goldens(mesh_scene())),
            ("frames", lambda: phase_frames(mesh_scene())),
            ("trainer", phase_trainer),
            ("cli", phase_cli),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            FAILED.append(f"{name}/exception")
        report(name, phase_seconds=time.perf_counter() - t0)
    if FAILED:
        print(f"FAILED: {FAILED}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
