"""blob82k frames end to end on the GPU: pair-block kernel vs plain search.

    python tools/pair_kernel_bench.py              # kernel plain plain kernel bvh
    python tools/pair_kernel_bench.py bvh          # the listed frames only

Renders blob82k 256² @ 64 spp (lanes 49152) through the wavefront
engine with the Triton pair-block kernel, with the plain jnp search, then
each again in the opposite order (kernel, plain, plain, kernel), and
through the stackless BVH walk (accel/traverse.py), the traversal that
needs no kernel. One JSON line per frame, each naming the card.
"""

import json
import os
import subprocess
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

LANES = 49152
SPP = 64
DEFAULT_RUNS = ("kernel", "plain", "plain", "kernel", "bvh")


def main(runs):
    import bench
    from pathtrace_tpu.models import procedural
    from pathtrace_tpu.ops.pallas import pair_kernel as pk
    from pathtrace_tpu.utils.cache import setup_compile_cache

    bench.require_gpu()
    setup_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()

    def out(**kw):
        kw.pop("image")
        print(json.dumps({**kw, "xla_flags": os.environ.get("XLA_FLAGS", ""),
                          "card": card}), flush=True)

    frame = f"blob82k_256x256_{SPP}spp"
    if "bvh" in runs:
        bvh = procedural.blob_mesh_scene().with_bvh().to_device()
    if {"kernel", "plain"} & set(runs):
        blob = procedural.blob_mesh_scene().with_kd_binned().to_device()
    for label in runs:
        if label == "bvh":
            out(search="raycast_bvh", frame=frame,
                **bench.time_frame(bvh, 256, 256, SPP, LANES))
            continue
        jax.clear_caches()   # the two searches compile distinct programs
        swap = {"gpu": pk.pair_search_plain} if label == "plain" else {}
        with mock.patch.dict(pk.IMPLEMENTATIONS, swap):
            out(search=label, frame=frame,
                **bench.time_frame(blob, 256, 256, SPP, LANES))


if __name__ == "__main__":
    runs = tuple(sys.argv[1:]) or DEFAULT_RUNS
    bad = set(runs) - set(DEFAULT_RUNS)
    if bad:
        raise SystemExit(f"unknown runs {sorted(bad)}; "
                         f"choose from {sorted(set(DEFAULT_RUNS))}")
    main(runs)
