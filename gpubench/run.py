"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, then ``checks``: each compared number
with its limit); the compared numbers are also the last lines of standard
error. A detail file goes to ``gpubench/out/<workload>-<seed>-<trace>.json``
inside the checkout. Without a CUDA device, or with a module of JAX or of
the JAX package loaded once the window has closed, the run prints no
result and exits with 2 or 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# The checkout's root, not this folder, is where packages are found: the
# folder's modules are ``gpubench.*``.
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)

# One CPU thread for torch's and OpenMP's pools, as each configuration's
# ``assumed`` states: the port's host work is one thread queueing the card,
# pool threads spinning between the solve's small CPU ops would take cores
# from it, and the port sets no thread count of its own.
os.environ["OMP_NUM_THREADS"] = "1"
# Every build and kernel cache at a fixed path inside the checkout. The
# port's own kernels build under pointcloudprocessor_tpu_torch/kernels/_build/.
CACHE = os.path.join(HERE, ".cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("gpubench: no CUDA device: this benchmark runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from gpubench import harness

    out = harness.execute(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                          "cuda", t_start=T_START)
    found = harness.forbidden_modules(list(sys.modules))
    if found:
        print(f"gpubench: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    res = out["result"]
    os.makedirs(os.path.join(HERE, "out"), exist_ok=True)
    with open(os.path.join(HERE, "out", f"{args.workload}-{args.seed}-{args.trace}.json"),
              "w") as f:
        json.dump({"result": res, **out["detail"]}, f, indent=1, default=str)
    for k, c in res["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
