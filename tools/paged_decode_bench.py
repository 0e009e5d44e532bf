#!/usr/bin/env python3
"""Times the paged decode kernel (K2, bf16 and int8) of the port in a
checkout on one GPU, at chip_smoke.py's phase-2 decode shape (8 sequences,
Llama-3-8B heads, sum valid_len 3167) and at one sequence of 8191 cached
positions (the most kv splits):

    python3 tools/paged_decode_bench.py [CHECKOUT]

CHECKOUT (default: this repository) is the root of a checkout whose
``k8s_dra_driver_tpu_torch`` and ``chip_smoke.py`` are imported, so two
trees of the kernel can be compared on one card in one call. Prints one
JSON line: per case the median milliseconds of three ``chip_smoke.time_ms``
runs (CUDA events, L2 evicted before each call), the largest error against
the plain version, the host's microseconds per call (200 calls enqueued
back to back), and each kernel's mean device microseconds over 20
calls under ``torch.profiler`` (a merge kernel launched as a programmatic
dependent counts from its early start, so its time includes its wait for
the split kernel)."""

import json
import sys
import time
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from k8s_dra_driver_tpu_torch.models.decode import _quantize_kv  # noqa: E402
from k8s_dra_driver_tpu_torch.ops import attention as att  # noqa: E402

CASES = {"phase2": [128, 212, 332, 732, 352, 438, 701, 272], "long": [8191]}


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_decode_bench: no CUDA device", file=sys.stderr)
        return 2
    if not Path(att.__file__).resolve().is_relative_to(ROOT):
        raise RuntimeError(f"imported {att.__file__}, not from {ROOT}")
    dev = torch.device("cuda")
    hq, hkv, d, bs = 32, 8, 128, 16
    results = {"card": cs.card_line()}
    for quantized in (False, True):
        for name, lens in CASES.items():
            gen = torch.Generator(device=dev)
            gen.manual_seed(7)
            k, v, tables = cs.paged_inputs(torch, gen, dev, lens, 8192 // bs,
                                           hkv, d)
            sc = {}
            if quantized:
                (k8, ks), (v8, vs) = _quantize_kv(k[None]), _quantize_kv(
                    v[None])
                k, v, sc = k8[0], v8[0], dict(k_scale=ks[0], v_scale=vs[0])
            q = torch.randn((len(lens), hq, d), generator=gen,
                            device=dev).bfloat16()
            vlen = torch.tensor(lens, dtype=torch.int32, device=dev)

            def call():
                return att.paged_decode_attention(q, k, v, tables, vlen, bs,
                                                  None, **sc)

            ref = att.paged_attention_reference(
                q[:, :, None], k, v, tables, (vlen.long() - 1)[:, None], bs,
                None, **sc)[:, :, 0]
            err = (call().float() - ref.float()).abs().max().item()
            ms = sorted(cs.time_ms(call) for _ in range(3))[1]
            # The host's cost of one call: 200 enqueued back to back.
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call()
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    cs._FLUSH[0].zero_()
                    call()
                torch.cuda.synchronize()
            kernels = {e.key[e.key.index("paged"):].split("(")[0]:
                       e.self_device_time_total / e.count
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and "paged" in e.key}
            results[name + ("_int8" if quantized else "")] = dict(
                ms=ms, host_us=host_us, max_abs_err=err, kernel_us=kernels)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
