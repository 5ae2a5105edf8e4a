"""Command-line harness: render / grad-check / bench subcommands.

Replaces the reference's interactive GLFW viewer + 'P'-key render trigger
(renderer.cpp:85-228, 284-289) with a headless CLI per the north star.

    python -m pathtrace_tpu.cli render --preset cornell64 --out out.png
    python -m pathtrace_tpu.cli grad-check --preset cornell64
    python -m pathtrace_tpu.cli bench --preset cornell64 --spp 64
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_render(args) -> int:
    from pathtrace_tpu.io import image as imageio
    from pathtrace_tpu.io import checkpoint as ckpt
    from pathtrace_tpu.integrator.render import render
    from pathtrace_tpu.models.presets import build_preset_scene, get_preset
    from pathtrace_tpu.models import procedural
    from pathtrace_tpu.utils import rng
    import jax.numpy as jnp
    import numpy as np

    preset = get_preset(args.preset)
    scene = build_preset_scene(preset)
    w = args.width or preset.width
    h = args.height or preset.height
    spp = args.spp or preset.spp
    camera = procedural.default_camera(w, h)
    passes = max(args.passes, 1)
    spp_per_pass = max(spp // passes, 1)
    use_wavefront = args.engine == "wavefront"
    cfg = preset.cfg
    if getattr(args, "hemisphere", "cosine") != cfg.hemisphere:
        import dataclasses
        cfg = dataclasses.replace(cfg, hemisphere=args.hemisphere)
    if getattr(args, "no_nee", False):
        import dataclasses
        cfg = dataclasses.replace(cfg, nee=False)

    start_pass = 0
    accum = jnp.zeros((h, w, 3), jnp.float32)
    if args.resume and args.checkpoint:
        try:
            state = ckpt.load_state(args.checkpoint)
            accum = jnp.asarray(state["accum_image"])
            start_pass = state["passes_done"]
            print(f"[resume] at pass {start_pass}", file=sys.stderr)
        except FileNotFoundError:
            pass

    key = rng.make_key(args.seed)
    for p in range(start_pass, passes):
        t0 = time.perf_counter()
        pass_key = rng.iter_key(key, 1000 + p)
        if use_wavefront:
            from pathtrace_tpu.integrator.wavefront import (
                render_wavefront_chunked)
            pass_img, _ = render_wavefront_chunked(
                scene, camera, spp_per_pass, pass_key, cfg)
        else:
            pass_img = render(scene, camera, spp_per_pass, pass_key,
                              cfg)
        accum = accum + pass_img
        accum.block_until_ready()
        dt = time.perf_counter() - t0
        # per-pass telemetry like the reference (pathtracer.cu:243)
        print(f"[pass {p}] {spp_per_pass}spp in {dt:.2f}s", file=sys.stderr)
        if args.out:
            imageio.write_png(args.out, accum / (p + 1))
        if args.checkpoint:
            ckpt.save_state(args.checkpoint, np.asarray(accum), p + 1,
                            args.seed, spp_per_pass)
    if args.out_npy:
        imageio.write_npy(args.out_npy, accum / passes)
    print(json.dumps({"passes": passes, "spp": spp_per_pass * passes,
                      "resolution": [w, h]}))
    return 0


def cmd_grad_check(args) -> int:
    import numpy as np
    from pathtrace_tpu.diff import fd_material_grad_auto, material_grads
    from pathtrace_tpu.diff.fd import make_frozen_sampler
    from pathtrace_tpu.integrator.config import IntegratorConfig
    from pathtrace_tpu.models.presets import build_preset_scene, get_preset
    from pathtrace_tpu.models import procedural
    from pathtrace_tpu.utils import rng

    preset = get_preset(args.preset)
    scene = build_preset_scene(preset)
    camera = procedural.default_camera(args.width or 32, args.height or 32)
    key = rng.make_key(args.seed)
    spp = args.spp or 8

    if args.quick:
        # LOOSE mode: live-sampler FD (reparameterized autodiff,
        # detach_sampling=False) with per-param tolerances up to 1e-1 -
        # fast sanity, not the contract. FD comparability: RR off
        # (discrete survival flips); see tests/test_grad.py FD_CFG.
        cfg = IntegratorConfig(rr_bounce=99, detach_sampling=False)
        frozen = None
        tol_of = {"albedo": 2e-2, "emittance": 2e-2, "roughness": 1e-1,
                  "specular": 5e-2}
        fd_kwargs = {}
    else:
        # STRONG contract (default; the committed oracle's config,
        # tools/gradcheck_oracle.py): PRODUCTION gradients
        # (detach_sampling=True) against frozen-sampling adaptive
        # central differences with Richardson extrapolation at the
        # north-star 1e-3. Freezing the sampling-side materials pins the
        # path realization, so FD measures exactly the detached-sampling
        # derivative autodiff computes.
        cfg = IntegratorConfig(rr_bounce=99, detach_sampling=True)
        frozen = make_frozen_sampler(scene)
        tol_of = {"albedo": 1e-3, "emittance": 1e-3, "roughness": 1e-3,
                  "specular": 1e-3}
        fd_kwargs = dict(h_min=1e-4, agree=0.001, richardson=True)

    g_tri, g_sph, loss = material_grads(scene, camera, spp, key, cfg=cfg)
    checks = []
    light = int(np.asarray(scene.lights)[0])
    # Adaptive FD steps: the estimator is only piecewise-smooth (sampled
    # directions cross accept/reject boundaries, CudaUtil.cuh:335-338), so
    # each probe halves h until consecutive estimates agree - see
    # diff/fd.py fd_material_grad_auto.
    for target, field, idx, h0 in [
        ("tris", "albedo", (0, 0), 2e-2),
        ("tris", "emittance", (light, 0), 5e-2),
        ("tris", "roughness", (2,), 1e-2),
        ("tris", "specular", (4, 0), 1e-2),
    ]:
        fd, h_used, conv = fd_material_grad_auto(
            scene, camera, spp, key, target, field, idx, h0=h0, cfg=cfg,
            sample_mat_fn=frozen, **fd_kwargs)
        ad = float(np.asarray(getattr(g_tri, field))[idx])
        rel = abs(ad - fd) / max(abs(fd), abs(ad), 1.0)
        tol = tol_of[field]
        checks.append({"param": f"{field}{list(idx)}", "autodiff": ad,
                       "fd": fd, "fd_h": h_used, "fd_converged": conv,
                       "rel_err": rel, "tol": tol, "ok": rel < tol})
    ok = all(c["ok"] for c in checks)
    print(json.dumps({"loss": float(loss),
                      "mode": "quick" if args.quick else "strong-1e-3",
                      "max_rel_err": max(c["rel_err"] for c in checks),
                      "checks": checks, "pass": ok}, indent=2))
    return 0 if ok else 1


def cmd_bench(args) -> int:
    import os
    if args.width:
        os.environ["BENCH_W"] = str(args.width)
    if args.height:
        os.environ["BENCH_H"] = str(args.height)
    if args.spp:
        os.environ["BENCH_SPP"] = str(args.spp)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench
    bench.main()
    return 0


def main(argv=None) -> int:
    from pathtrace_tpu.utils.cache import setup_compile_cache

    p = argparse.ArgumentParser(prog="pathtrace_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="headless render to PNG/npy")
    pr.add_argument("--preset", default="cornell64")
    pr.add_argument("--width", type=int, default=0)
    pr.add_argument("--height", type=int, default=0)
    pr.add_argument("--spp", type=int, default=0)
    pr.add_argument("--passes", type=int, default=1)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--out", default="result.png")
    pr.add_argument("--out-npy", default="")
    pr.add_argument("--checkpoint", default="")
    pr.add_argument("--resume", action="store_true")
    pr.add_argument("--engine", default="wavefront",
                    choices=("wavefront", "megakernel"))
    pr.add_argument("--hemisphere", default="cosine",
                    choices=("cosine", "uniform"),
                    help="diffuse hemisphere sampling A/B "
                         "(Bxdf.cuh:23-41, Img/Render/64sppWith*.png)")
    pr.add_argument("--no-nee", dest="no_nee", action="store_true",
                    help="disable next-event estimation "
                         "(README.md:56-58 A/B)")
    pr.set_defaults(fn=cmd_render)

    pg = sub.add_parser("grad-check", help="autodiff vs FD oracle")
    pg.add_argument("--preset", default="cornell64")
    pg.add_argument("--width", type=int, default=0)
    pg.add_argument("--height", type=int, default=0)
    pg.add_argument("--spp", type=int, default=0)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--quick", action="store_true",
                    help="loose live-sampler FD mode (fast sanity); "
                         "default runs the strong frozen-sampling "
                         "contract at 1e-3 (tools/gradcheck_oracle.py)")
    pg.set_defaults(fn=cmd_grad_check)

    pb = sub.add_parser("bench", help="throughput benchmark")
    pb.add_argument("--preset", default="cornell64")
    pb.add_argument("--width", type=int, default=0)
    pb.add_argument("--height", type=int, default=0)
    pb.add_argument("--spp", type=int, default=0)
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    setup_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
