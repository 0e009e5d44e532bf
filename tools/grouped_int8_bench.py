#!/usr/bin/env python3
"""A7b (``grouped_matmul_int8``, the int8 grouped product of tensor-parallel
MoE serving) on one GPU, at chip_smoke phase 35's shapes, for one tree of
the port:

    python3 tools/grouped_int8_bench.py [--root DIR] [--out FILE] [--profile]
        [--outputs FILE]

``--root`` takes ``k8s_dra_driver_tpu_torch`` from another checkout (an
older tree unpacked by ``git archive``; its kernels build into that
tree's ``build/kernels``), so two trees can be timed in turns inside one
call on one card (parent, change, change, parent). Timing, inputs and
bounds are this tree's chip_smoke's for every tree.

1. ``rows``: phase 35's four rows (``chip_smoke.check_grouped_int8``'s
   operands: layer 0 of the int8 Mixtral-8x7B, tensor shard 0 of 4's
   gate/up block [8, 4096, 2, 3584], a strided view, and down block [8,
   3584, 4096]; the decode step's BATCH_SLOTS tokens and a prefill
   chunk's PREFILL_BATCH x PREFILL_CHUNK), each through ``time_ms``
   (median of 20 calls by CUDA events, L2 evicted before each) and, at
   decode, ``graph_ms`` (a launch among 50 in a CUDA graph), beside
   ``bound_fields`` and ``torch._grouped_mm`` on a bf16 copy of the
   weight (``library_grouped_mm``: a yardstick, no PyTorch call computes
   the int8 function), with the launch plan where the tree has one
   (``int8_gmm_plan``).
   With ``--outputs FILE`` each row's output is saved to FILE, or, where
   FILE exists (another tree's run), held against it: ``bitwise_equal``
   and the count of differing values a row.
2. ``profile`` (``--profile``): the whole 32-layer int8 model on
   ``MeshConfig(tensor=4)`` of the card, phase 35's captured decode step
   (``chip_smoke.profile_decode`` with the int8 KV cache): its device ms
   by CUDA events, and the A7b group's device ms and launches in the
   step's profile.

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


def rows(md, qlayer, cfg, dev, tp, outputs=None) -> dict:
    """Phase 35's four rows of A7b (see the module docstring)."""
    out = {}
    saved = (torch.load(outputs) if outputs and Path(outputs).exists()
             else None)
    kept = {}
    for tag, t, seed in (("", cs.BATCH_SLOTS, cs.SEED + 60),
                         ("_prefill", cs.PREFILL_BATCH * cs.PREFILL_CHUNK,
                          cs.SEED + 61)):
        plan, xs, act, gu_blk, dn_blk = cs.int8_grouped_inputs(
            torch, qlayer, cfg, dev, t, tp, seed)
        sizes = plan.sizes_aligned
        live = int((plan.pair_ids < plan.n_pairs).sum())
        touched = int((sizes > 0).sum())
        offs = torch.cumsum(sizes, 0).to(torch.int32)
        for part, lhs, w in (("_gateup", xs, gu_blk), ("_down", act, dn_blk)):
            name = f"grouped_matmul_int8{tag}{part}"
            e, k = w.q.shape[0], w.q.shape[1]
            n = (2 * w.q.shape[-1]) if w.q.dim() == 4 else w.q.shape[-1]

            def kernel(lhs=lhs, w=w):
                return md.grouped_matmul_int8(lhs, w.q, w.scale, sizes)

            y = kernel()
            torch.cuda.synchronize()
            nbytes = (touched * k * n + touched * n * 4 + live * k * 2
                      + plan.r_pad * n * 2)
            row = dict(
                ms=cs.time_ms(kernel),
                shape=(f"T {t}, r_pad {plan.r_pad}, live rows {live}, "
                       f"experts touched {touched}, K {k}, N {n}"),
                **cs.bound_fields(name, nbytes, 2 * live * k * n,
                                  cs.BF16_FLOPS))
            if not tag:
                row["graph_ms"] = cs.graph_ms(torch, kernel)
            if hasattr(md, "int8_gmm_launch"):
                row["plan"] = md.int8_gmm_launch(
                    lhs, w.q, w.scale, sizes).plan._asdict()
            wb = md._int8_flat(w.q, w.scale)[0].to(torch.bfloat16)
            row["library_ms"], row["library_refusals"] = \
                cs.library_grouped_mm(torch, lhs, wb, offs, False)
            del wb
            if saved is not None:
                row["differing"] = int((y != saved[name].to(dev)).sum())
                row["bitwise_equal"] = row["differing"] == 0
            kept[name] = y.cpu()
            out[name] = row
            cs.log(f"{name}: {json.dumps(row)}")
            torch.cuda.empty_cache()
    if outputs and saved is None:
        Path(outputs).parent.mkdir(parents=True, exist_ok=True)
        torch.save(kept, outputs)
    return out


def profile(qparams, cfg, dev, tp) -> dict:
    """Phase 35's captured decode step (see the module docstring)."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.quant import quantize_specs

    mesh = cs.card_mesh(dev, tensor=tp)
    sharded = cs.shard_in_place(torch, qparams, mesh,
                                quantize_specs(moe.param_specs(cfg)))
    prof = cs.profile_decode(torch, sharded, cfg, dev, quantize_cache=True,
                             mesh=mesh, eager=False)
    split = prof["captured_profile"]
    if not isinstance(split, dict):  # the profiler saw no kernel
        split = {}
    return dict(
        captured_device_ms=prof["captured_device_ms"],
        captured_step_ms=prof["captured_step_ms"],
        profiler_sees_kernels=prof["captured_profiler_sees_kernels"],
        a7b_ms=split.get("group_ms", {}).get("grouped_matmul_int8"),
        a7b_launches=split.get("group_launches", {}).get(
            "grouped_matmul_int8"),
        group_ms=split.get("group_ms"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out", default=None)
    ap.add_argument("--outputs", default=None,
                    help="save each row's output here, or compare with "
                         "the outputs saved here by another tree's run")
    ap.add_argument("--profile", action="store_true",
                    help="also build the whole 32-layer model and profile "
                         "phase 35's captured decode step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grouped_int8_bench: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    from k8s_dra_driver_tpu_torch.models import MOE_PRESETS
    from k8s_dra_driver_tpu_torch.ops import moe_dispatch as md

    if not Path(md.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {md.__file__}, not from {root}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    tp = cs.TP_MOE_MESH["tensor"]
    cfg = MOE_PRESETS["8x7b"]
    # Layer 0 is the same draw at any depth (int8_moe_params).
    qparams = cs.int8_moe_params(
        torch, cfg if args.profile else dataclasses.replace(cfg, n_layers=1),
        dev)
    qlayer = {k: w[0] for k, w in qparams["layers"].items()}
    out = {"root": str(root),
           "rows": rows(md, qlayer, cfg, dev, tp, args.outputs)}
    if args.profile:
        out["profile"] = profile(qparams, cfg, dev, tp)
    print(cs.card_line())
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
