#!/usr/bin/env python3
"""K9 (the ring hop, ``csrc/ring_permute.cu``) on one GPU at the shapes the
expert-parallel paths launch it, for one tree of the port:

    python3 tools/ring_permute_bench.py [--root DIR] [--layers N] [--out FILE]

``--root`` takes ``k8s_dra_driver_tpu_torch`` from another checkout (an
older tree unpacked by ``git archive``; its kernels build into that
tree's ``build/kernels``), so two trees can be timed in turns inside one
call on one card (parent, change, change, parent). Every tree is timed by
this tree's ``chip_smoke``: ``time_ms`` (median of 20 calls by CUDA
events, L2 evicted before each) and ``graph_ms`` (a launch's device time
among 50 in one CUDA graph, the captured step's setting).

1. ``rows``: chip_smoke's ``time_ring_rows`` on 4 shards of the card --
   the [128, 4096] bf16 chunk, the f32 carrier, 256 MB a shard, each one
   ring through ``ring_permute_kernel``; and the hop (the chunk beside
   the carrier, at the prefill shape [128, 4096] and the decode step's
   [2, 4096]) as one launch a ring (``two_launches_*``: every tree) and,
   where the tree has ``ring_permute_group``, as one grouped launch. Each
   beside the plain version, ``torch._foreach_copy_`` over the same
   buffers and its bound (every byte read and written once at 3.35 TB/s).
2. ``decode_step``: the EP decode step (chip_smoke ``profile_decode`` on
   ``ep_mesh``: 8 sequences at 384 cached positions) on Mixtral-8x7B's
   widths cut to ``--layers`` layers (4 unless given), dropless on the
   ring: its device ms and K9's ms and launches a step, eager and, where
   the profiler sees inside the graph, captured.

Prints the card's name and power limit, then one JSON line (also written
to ``--out``)."""

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def decode_step(dev, layers: int) -> dict:
    from k8s_dra_driver_tpu_torch.models import MOE_PRESETS, moe
    from k8s_dra_driver_tpu_torch.parallel import ring, shard_pytree

    cfg = dataclasses.replace(MOE_PRESETS["8x7b"], n_layers=layers,
                              moe_impl="dropless")
    params = moe.init_params(cfg, seed=cs.SEED, device=dev)
    mesh = cs.ep_mesh(dev)
    sharded = shard_pytree(params, mesh, moe.param_specs(cfg))
    before = ring.ring_permute_kernel.launches
    prof = cs.profile_decode(torch, sharded, cfg, dev, mesh=mesh)
    result = dict(
        layers=layers, device_ms=prof["device_ms"],
        k9_ms=prof["group_ms"]["ring_permute"],
        k9_launches=prof["group_launches"]["ring_permute"],
        captured_device_ms=prof["captured_device_ms"],
        captured_step_ms=prof["captured_step_ms"],
        wrapper_launches=ring.ring_permute_kernel.launches - before)
    captured = prof["captured_profile"]
    if isinstance(captured, dict):
        result.update(
            captured_k9_ms=captured["group_ms"]["ring_permute"],
            captured_k9_launches=captured["group_launches"]["ring_permute"],
            captured_profiled_device_ms=captured["device_ms"])
    del params, sharded
    torch.cuda.empty_cache()
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out", default=None)
    ap.add_argument("--layers", type=int, default=4,
                    help="the EP decode step's layers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ring_permute_bench: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    from k8s_dra_driver_tpu_torch.models import MOE_PRESETS
    from k8s_dra_driver_tpu_torch.parallel import ring

    if not Path(ring.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {ring.__file__}, not from {root}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 91)
    out = {"root": str(root),
           "rows": cs.time_ring_rows(torch, ring, gen, dev,
                                     MOE_PRESETS["8x7b"].hidden),
           "decode_step": decode_step(dev, args.layers)}
    print(cs.card_line())
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
