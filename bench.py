"""Throughput of one frame on the GPU: rays/s and camera paths/s.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"detail"}; detail names the platform, device kind and device count.

vs_baseline compares camera-path throughput against the reference's only
derivable number (BASELINE.md): the DiffuseRoom 13-minute render on a
GTX-10xx implies ~54M camera paths/s; rays/s is measured directly by
instrumented counting (closest-hit + shadow traversals, the reference's
HOT LOOP #1/#2, SURVEY.md §3.4).

    python bench.py                         # Cornell + spheres, 256² @ 1024
    BENCH_SCENE=mesh BENCH_SPP=64 python bench.py

Env: BENCH_SCENE (cornell | glass | mesh), BENCH_W, BENCH_H, BENCH_SPP,
BENCH_LANES, BENCH_REPEATS. Exits non-zero when JAX finds no GPU.
"""

import json
import os
import statistics
import time

import jax

REF_PATHS_PER_SEC = 54e6  # BASELINE.md derived ballpark (13-min DiffuseRoom)

# persistent wavefront width per scene; spp chunks per device launch
DEFAULT_LANES = {"cornell": 65536, "glass": 65536, "mesh": 49152}
CHUNK_SPP = 64


def build_scene(which: str):
    """The benchmark scenes, on the device."""
    from pathtrace_tpu.models import procedural

    if which == "mesh":
        # the committed 82k-tri OBJ asset through the OBJ/MTL loader and
        # the KD-cell pair-block traversal (assets/blob82k.obj)
        scene = procedural.blob_mesh_scene().with_kd_binned(max_tris=1024)
    elif which == "glass":
        scene = procedural.glass_scene().with_mt()
    elif which == "cornell":
        scene = procedural.cornell_box_scene(include_spheres=True).with_mt()
    else:
        raise ValueError(f"unknown scene {which!r}")
    return scene.to_device()


def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> None:
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX found only {platform!r} devices")


def peak_bytes() -> int:
    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


def time_frame(scene, w: int, h: int, spp: int, lanes: int,
               repeats: int = 1) -> dict:
    """Render one (w, h, spp) frame on the wavefront engine `repeats`
    times after a compiling warm-up through the same program."""
    from pathtrace_tpu.integrator.config import IntegratorConfig
    from pathtrace_tpu.integrator.wavefront import render_wavefront_chunked
    from pathtrace_tpu.models import procedural
    from pathtrace_tpu.utils import rng

    camera = procedural.default_camera(w, h)
    key = rng.make_key(0)

    def run(n, chunk):
        return render_wavefront_chunked(scene, camera, n, key,
                                        IntegratorConfig(), lanes,
                                        chunk_spp=chunk)

    t0 = time.perf_counter()
    run(4, 4)[0].block_until_ready()   # compiles the chunk program
    compile_s = time.perf_counter() - t0
    secs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        img, nrays = run(spp, CHUNK_SPP)
        img.block_until_ready()
        secs.append(time.perf_counter() - t0)
    dt = statistics.median(secs)
    paths = w * h * spp
    return {
        "paths_per_sec": paths / dt,
        "rays_per_sec": nrays / dt,
        "rays_per_path": nrays / paths,
        "seconds": dt,
        "seconds_all": secs,
        "compile_seconds": compile_s,
        "peak_bytes": peak_bytes(),
        "image": img,
    }


def main():
    from pathtrace_tpu.utils.cache import setup_compile_cache

    require_gpu()
    setup_compile_cache()
    which = os.environ.get("BENCH_SCENE", "cornell")
    w = int(os.environ.get("BENCH_W", 256))
    h = int(os.environ.get("BENCH_H", 256))
    spp = int(os.environ.get("BENCH_SPP", 1024))
    lanes = int(os.environ.get("BENCH_LANES", DEFAULT_LANES[which]))
    repeats = int(os.environ.get("BENCH_REPEATS", 5))

    r = time_frame(build_scene(which), w, h, spp, lanes, repeats)
    print(json.dumps({
        "metric": f"rays_per_sec_{which}_{spp}spp",
        "value": r["rays_per_sec"],
        "unit": "rays/s",
        "vs_baseline": r["paths_per_sec"] / REF_PATHS_PER_SEC,
        "detail": {
            "paths_per_sec": r["paths_per_sec"],
            "rays_per_path": r["rays_per_path"],
            "resolution": [w, h],
            "spp": spp,
            "lanes": lanes,
            "seconds_median": r["seconds"],
            "seconds_all": r["seconds_all"],
            "compile_seconds": r["compile_seconds"],
            "peak_bytes": r["peak_bytes"],
            "device": device_info(),
        },
    }))


if __name__ == "__main__":
    main()
