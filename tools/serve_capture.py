#!/usr/bin/env python3
"""A captured serving engine's capture seconds and TTFT on one GPU, for
one tree of the port:

    python3 tools/serve_capture.py [--root DIR] [--model 8b|8x7b-L16]
                                   [--repeats N] [--out FILE]

Builds the model once from chip_smoke's seed (``8b``: phase 4's 32-layer
Llama-3-8B; ``8x7b-L16``: phase 9's Mixtral-8x7B widths at 16 layers)
and serves chip_smoke's phase-4 traffic ``--repeats`` times through
``chip_smoke.serve``, each time on a fresh ``DecodeEngine`` whose decode
and prefill steps are captured anew. ``--root`` takes ``chip_smoke`` and
``k8s_dra_driver_tpu_torch`` from another checkout (an older tree
unpacked by ``git archive``), so two trees can be run in turns inside one
call on one card. A run's TTFT holds its captures' host seconds
(``capture_s``), which vary from run to run on a shared host; this
script repeats them in one process to tell a change in the captures from
that spread. Prints the card's name and power limit, then one JSON line
(also written to ``--out``)."""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--model", choices=("8b", "8x7b-L16"), default="8x7b-L16")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("serve_capture: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from k8s_dra_driver_tpu_torch.models import MOE_PRESETS, PRESETS, moe
    from k8s_dra_driver_tpu_torch.models import init_params

    if not Path(cs.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {cs.__file__}, not from {root}")
    dev = torch.device("cuda")
    if args.model == "8b":
        cfg = PRESETS["8b"]
        params = init_params(cfg, seed=cs.SEED, device=dev)
    else:
        cfg = dataclasses.replace(MOE_PRESETS["8x7b"],
                                  n_layers=cs.MOE_LAYERS)
        params = moe.init_params(cfg, seed=cs.SEED, device=dev)
    runs = []
    for _ in range(args.repeats):
        served = cs.serve(torch, params, cfg, dev)
        runs.append({k: served[k] for k in (
            "capture_s", "ttft_p50_ms", "ttft_p99_ms", "decode_step_p50_ms",
            "wall_s")})
        torch.cuda.synchronize()
    out = {"root": str(root), "model": args.model, "runs": runs}
    print(cs.card_line())
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
