#!/usr/bin/env python3
"""Times of the fused MoE dispatch kernels K7 (``moe_gateup``) and K8
(``moe_down_combine``), both branches, on one GPU, at chip_smoke.py's
shapes on one layer of a MoE preset (Mixtral-8x7B's by default):

    python3 tools/moe_dispatch_parts.py [--root DIR] [--preset NAME] [--parts]

``--root DIR`` imports ``k8s_dra_driver_tpu_torch`` from DIR instead of
this checkout (e.g. another commit unpacked by ``git archive`` into
``build/parent``), so one call on one card times two trees in turns.
``--preset NAME`` takes the widths of another ``MOE_PRESETS`` entry
(e.g. ``8x160m``); the token counts and tiles stay.

1. ``entry``: the four entry points through their public wrappers at the
   decode step (T 8, tile 8), the packed prefill chunk (T 512, tile 128)
   and the training shape (T 8192, tile 128), plans from the layer's
   router over normed random hidden states (chip_smoke.py's recipe), the
   int8 experts quantized per output column.
2. ``plans`` (trees with ``ops.moe_dispatch.dispatch_plan`` only): at the
   decode and prefill shapes, K7 in each form of the body (the wgmma body
   and, int8 at decode only, its swapped form), and K8 in each with its
   contracted axis whole and, int8 only, split 2 and 4 ways, beside the
   launch the plan picks.
3. ``parts`` (with ``--parts``): ``csrc/moe_dispatch.cu`` built again
   (into ``build/moe_dispatch_parts/``) with parts of the body compiled
   out by its ``MOE_DISPATCH_NO_*`` macros, one ``nvcc`` each, all
   started together: ``full`` (none), ``no_convert`` (the int8 consumers
   skip the conversion), ``no_products`` (no wgmma), ``loads_only``
   (neither) and ``no_loads`` (neither, and the producers arrive on each
   stage's barrier without loading). K7 and K8 in the wgmma body at the
   decode (int8: its swapped form) and prefill shapes, both branches. Their
   outputs are wrong by construction; only their times are read.

Times are chip_smoke.time_ms medians (CUDA events, L2 evicted before each
call). Prints the card's name and power limit, then one JSON line."""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SHAPES = (("decode", 8, 8), ("prefill", 512, 128), ("train", 8192, 128))
CONVERT, PRODUCTS, LOADS = (f"-DMOE_DISPATCH_NO_{part}"
                            for part in ("CONVERT", "PRODUCTS", "LOADS"))
VARIANTS = {"full": (), "no_convert": (CONVERT,), "no_products": (PRODUCTS,),
            "loads_only": (CONVERT, PRODUCTS),
            "no_loads": (CONVERT, PRODUCTS, LOADS)}


def build_variants(md, _build) -> dict:
    """The library once per VARIANTS entry, its C signatures declared as
    ``md._library`` declares them."""
    out = ROOT / "build" / "moe_dispatch_parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in VARIANTS.items():
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
               str(out / f"{name}.so"), str(_build.CSRC / "moe_dispatch.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, types in (("moe_gateup", md._GATEUP_ARGTYPES),
                          ("moe_down_combine", md._DOWN_ARGTYPES),
                          ("moe_gateup_int8", md._GATEUP_INT8_ARGTYPES),
                          ("moe_down_combine_int8", md._DOWN_INT8_ARGTYPES)):
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--preset", default="8x7b-L1")
    ap.add_argument("--parts", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("moe_dispatch_parts: no CUDA device", file=sys.stderr)
        return 2
    import k8s_dra_driver_tpu_torch
    from k8s_dra_driver_tpu_torch.models import MOE_PRESETS, moe
    from k8s_dra_driver_tpu_torch.models.quant import quantize_tensor
    from k8s_dra_driver_tpu_torch.ops import moe_dispatch as md
    from k8s_dra_driver_tpu_torch.ops import _build, norms

    dev = torch.device("cuda")
    cfg = MOE_PRESETS[args.preset]
    params = moe.init_params(cfg, seed=cs.SEED + 5, device=dev)
    layer = {k: w[0] for k, w in params["layers"].items()}
    del params
    torch.cuda.empty_cache()
    h, m, e, k = cfg.hidden, cfg.mlp_hidden, cfg.n_experts, cfg.top_k
    q_gu = quantize_tensor(layer["w_gateup"], 1)
    q_dn = quantize_tensor(layer["w_down"], 1)
    branches = (("bf16", layer["w_gateup"], None, layer["w_down"], None),
                ("int8", q_gu.q, q_gu.scale, q_dn.q, q_dn.scale))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 20)
    result = {"package": str(Path(k8s_dra_driver_tpu_torch.__file__).parent),
              "preset": args.preset,
              "entry": {}, "plans": {}, "parts": {}}
    libs = build_variants(md, _build) if args.parts else {}
    for name, t, tile in SHAPES:
        x = torch.randn((t, h), generator=gen, device=dev).to(torch.bfloat16)
        xf = norms.rmsnorm_reference(x, layer["ln_mlp"], cfg.norm_eps)
        gates, experts, _, _ = moe._route_topk(xf, layer["wr"], cfg)
        plan = md.build_plan(experts.reshape(-1), t, e, k)
        if plan.tile_rows != tile:
            raise AssertionError(f"{name}: tile {plan.tile_rows}, want {tile}")
        gates_pad = md._take_rows(gates.reshape(-1),
                                  plan.pair_ids).contiguous()
        for branch, wg, sg, wd, sd in branches:
            act = md.moe_gateup(xf, wg, plan, sg)
            result["entry"][f"{name} {branch}"] = {
                "moe_gateup": cs.time_ms(
                    lambda: md.moe_gateup(xf, wg, plan, sg)),
                "moe_down_combine": cs.time_ms(
                    lambda: md.moe_down_combine(act, wd, gates_pad, plan,
                                                sd)),
            }
            if libs and name != "train":
                form = ("swapped" if name == "decode" and sg is not None
                        else "wgmma")
                wide = md.MoePlan(form, 128, form, 256, 1, m)
                q = "" if sg is None else "_int8"
                parts = {}
                own = md._LIB
                for variant, lib in libs.items():
                    md._LIB = lib
                    parts[f"moe_gateup {variant}"] = cs.time_ms(
                        lambda: md._gateup_launch("moe_gateup" + q, xf, wg,
                                                  sg, plan, wide))
                    parts[f"moe_down_combine {variant}"] = cs.time_ms(
                        lambda: md._down_launch("moe_down_combine" + q, act,
                                                wd, sd, gates_pad, plan,
                                                wide))
                md._LIB = own
                result["parts"][f"{name} {branch}"] = parts
            if name == "train" or not hasattr(md, "dispatch_plan"):
                continue
            q = "" if sg is None else "_int8"
            chosen = md.dispatch_plan(tile, plan.r_pad, h, m, sg is not None,
                                      md.sm_count(dev))
            bodies = [body for body in md.BODIES if body != "swapped"
                      or (sg is not None and name == "decode")]
            options = {f"{body} split {s}": md.MoePlan(body, 128, body, 256,
                                                       s, m // s)
                       for body in bodies
                       for s in ((1,) if sg is None else (1, 2, 4))}
            times = {"plan": chosen._asdict()}
            for label, launch in options.items():
                times[f"moe_down_combine {label}"] = cs.time_ms(
                    lambda: md._down_launch("moe_down_combine" + q, act, wd,
                                            sd, gates_pad, plan, launch))
            for body in bodies:
                times[f"moe_gateup {body}"] = cs.time_ms(
                    lambda: md._gateup_launch("moe_gateup" + q, xf, wg, sg,
                                              plan,
                                              options[f"{body} split 1"]))
            result["plans"][f"{name} {branch}"] = times
        torch.cuda.empty_cache()
    print(cs.card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
