"""Where a fresh serving process's first request goes, on the card.

A worker started for a claim (``chip_smoke.py`` phases 26-28) waits many
times longer for its first token than phase 4's engine does in a warm
process. This script splits that wait. For each mode it starts a fresh process
of itself, which times in turn: importing torch, the CUDA start, loading
the kernels' libraries (built beforehand by this script's parent),
drawing the 8B weights, the first Triton RMSNorm call, and phase 4's
traffic served twice through ``chip_smoke.serve`` (steps captured, or
eager with ``--modes eager``). With ``--profile`` the first serve runs
under ``cProfile`` and the child reports the seconds it spent compiling
Python sources and the top entries by cumulative time. One JSON line a
mode.

    python3 tools/first_serve.py [--modes captured eager] [--profile]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def profile_summary(prof) -> dict:
    """Seconds spent compiling Python sources (their own time: no
    bytecode cache means every fresh process compiles what it imports)
    and the top 15 entries by cumulative time (which counts recursive
    calls more than once: read them as an order, not as sums)."""
    import pstats

    stats = pstats.Stats(prof).stats
    compile_s = sum(tottime for (_, _, name), (_, _, tottime, _, _)
                    in stats.items()
                    if name == "<built-in method builtins.compile>")
    top = sorted(stats.items(), key=lambda kv: -kv[1][3])[:15]
    return {"compile_source_s": compile_s,
            "top": [f"{cum:.2f}s {Path(path).name}:{line}({name})"
                    for (path, line, name), (_, _, _, cum, _) in top]}


def child(mode: str, profile: bool) -> dict:
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch

    out = {"mode": mode, "import_torch_s": time.perf_counter() - T0}
    if not torch.cuda.is_available():
        raise SystemExit("first_serve: no CUDA device")

    def stage(name, fn):
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t
        return result

    import chip_smoke
    from k8s_dra_driver_tpu_torch.models import PRESETS, init_params
    from k8s_dra_driver_tpu_torch.ops import _build, norms

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    stage("cuda_start_s", torch.cuda.mem_get_info)
    stage("libraries_s", lambda: [_build.load(n) for n in _build.sources()])
    params = stage("weights_s", lambda: init_params(
        PRESETS["8b"], seed=chip_smoke.SEED, device=dev))
    x = torch.randn(8, 4096, device=dev, dtype=torch.bfloat16)
    w = torch.ones(4096, device=dev, dtype=torch.bfloat16)
    stage("first_rmsnorm_s", lambda: norms.rmsnorm(x, w))
    for i in range(2):
        prof = None
        if profile and i == 0:
            import cProfile

            prof = cProfile.Profile()
            prof.enable()
        m = chip_smoke.serve(torch, params, PRESETS["8b"], dev,
                             capture=mode == "captured")
        if prof is not None:
            prof.disable()
            out["profile"] = profile_summary(prof)
        out[f"serve{i}"] = {k: m[k] for k in (
            "wall_s", "capture_s", "ttft_p50_ms", "decode_step_p50_ms")}
    out["device"] = torch.cuda.get_device_name(0)
    out["total_s"] = time.perf_counter() - T0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", nargs="+", default=["captured", "eager"],
                    choices=["captured", "eager"])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.profile)), flush=True)
        return 0
    from k8s_dra_driver_tpu_torch.ops import _build

    _build.build()
    for mode in args.modes:
        cmd = [sys.executable, __file__, "--child", mode]
        if args.profile:
            cmd.append("--profile")
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
