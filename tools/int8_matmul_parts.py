#!/usr/bin/env python3
"""Where the time of ``int8_matmul``'s two bodies goes, on one GPU, at
chip_smoke.py's phase-16 shapes: the wgmma body (M > 64: the seams at M
512 and the expert product [8, 512, 4096] x [8, 4096, 28672], prologue
mode) and the swapped form (M <= 64: the seams at M 8):

    python3 tools/int8_matmul_parts.py

1. ``plans``: the library as built from ``csrc/quant_matmul.cu``, called
   through its C entry point with every K split the body takes (1, 2, 4;
   the swapped form also 8) that divides K, beside the one
   ``ops.quant_matmul.plan`` picks.
2. ``parts``: ``csrc/quant_matmul.cu`` built again (into
   ``build/int8_matmul_parts/``) with parts of both bodies compiled
   out by their ``INT8_WIDE_NO_*`` and ``INT8_SWAP_NO_*`` macros, one
   ``nvcc`` each, all started
   together: ``full`` (none), ``no_convert`` (the consumers skip the int8
   -> bf16 conversion), ``no_products`` (no wgmma), ``loads_only``
   (neither), and ``no_loads`` (neither, and the producer arrives on each
   stage's barrier without a TMA load). Their outputs are wrong by
   construction; only their times are read.

Times are chip_smoke.time_ms medians (CUDA events, L2 evicted before each
call). Prints the card's name and power limit, then one JSON line."""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from k8s_dra_driver_tpu_torch.ops import _build  # noqa: E402
from k8s_dra_driver_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from k8s_dra_driver_tpu_torch.ops._device import sm_count  # noqa: E402

SHAPES = [(f"{name} M {m}", 1, m, k, n, False)
          for m in (cs.BATCH_SLOTS, 512) for name, k, n in cs.INT8_SEAMS]
SHAPES.append(("experts", *cs.INT8_EXPERTS, True))


def _off(*parts):
    """The source's macros that compile these parts of both bodies out."""
    return tuple(f"-DINT8_{body}_NO_{part}" for part in parts
                 for body in ("WIDE", "SWAP"))


VARIANTS = {"full": (), "no_convert": _off("CONVERT"),
            "no_products": _off("PRODUCTS"),
            "loads_only": _off("CONVERT", "PRODUCTS"),
            "no_loads": _off("CONVERT", "PRODUCTS", "LOADS")}


def build_variants() -> dict:
    out = ROOT / "build" / "int8_matmul_parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in VARIANTS.items():
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
               str(out / f"{name}.so"),
               str(_build.CSRC / "quant_matmul.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.int8_matmul.argtypes = qm._ARGTYPES
        lib.int8_matmul.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("int8_matmul_parts: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    libs = build_variants()
    libs["library"] = qm._library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 70)
    result = {}
    for name, e, m, k, n, prologue in SHAPES:
        q = torch.randint(-127, 128, (e, k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = (0.5 + torch.rand((e, 1, n), generator=gen, device=dev)) / (
            127 * k ** 0.5)
        x = torch.randn((e, m, k), generator=gen, device=dev).to(
            torch.bfloat16)
        y = torch.empty((e, m, n), dtype=torch.bfloat16, device=dev)
        part = torch.empty((8, e, m, n), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib, split):
            rc = lib.int8_matmul(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                 y.data_ptr(), part.data_ptr(), e, m, n, k,
                                 split, int(prologue), stream)
            _build.check(rc, "int8_matmul")

        chosen = qm.plan(e, m, n, k, sm_count(dev))
        splits = (1, 2, 4) if chosen.wide else qm.SWAP_SPLITS
        plans = {f"split {split}": cs.time_ms(
            lambda: call(libs["library"], split))
            for split in splits if k % (qm.KERNEL_K_STEP * split) == 0}
        parts = {variant: cs.time_ms(lambda: call(libs[variant], chosen.split))
                 for variant in VARIANTS}
        result[name] = dict(plan=chosen._asdict(), plans=plans, parts=parts)
        del q, scale, x, y, part
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
