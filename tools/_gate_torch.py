"""What the port's gate tools share: their gate record, the device they
run on, and the model each runs there.

The model twins (``run_{decode,kv,trace,compute,moe,elastic}_smoke_torch``)
and ``chip_smoke.py``'s phase 44 take the model from here, so the tools
and the card's phase run the same one. On the CPU that is the
reference's ``tiny`` / ``tiny-moe`` preset. On the card the kernels take
bf16 and head widths that ``tiny`` (f32, head_dim 16) does not have, so
the llama tools run the 8b preset's widths cut to ``CARD_LAYERS``
layers, and the MoE tool Mixtral-8x7B's widths at one layer.

It imports nothing of JAX and no reference tool.
"""

CARD_PRESET, CARD_LAYERS = "8b", 2
CARD_MOE_PRESET = "8x7b-L1"


class Gates:
    """A smoke's gate results in order: (ok, what, kind), kind "gate" for
    a deterministic gate and "wall" for a wall-clock tripwire. With
    ``emit``, each is printed as the kv, trace and compute references
    print theirs."""

    def __init__(self, emit=None):
        self.results = []
        self.emit = emit

    def __call__(self, ok: bool, what: str, kind: str = "gate") -> None:
        self.results.append((bool(ok), what, kind))
        if self.emit is not None:
            self.emit(f"[{'ok ' if ok else 'FAIL'}] {what}")

    def failures(self, kinds=("gate", "wall")) -> list:
        return [w for ok, w, k in self.results if not ok and k in kinds]


def gate_device(name):
    """The device a tool's ``--device`` names (default the card; without
    one it raises, never falling back). On the CPU one intra-op thread:
    the tiny presets' ops are too small to share among threads, and one
    thread runs them faster and steadier on a shared host, where the
    wall-clock tripwires read the clock."""
    import torch

    from k8s_dra_driver_tpu_torch import resolve_device

    dev = resolve_device(name)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    return dev


def model_config(device):
    """The llama config the tools run on ``device``."""
    import dataclasses

    import torch

    from k8s_dra_driver_tpu_torch.models.llama import PRESETS

    if torch.device(device).type != "cuda":
        return PRESETS["tiny"]
    return dataclasses.replace(PRESETS[CARD_PRESET], n_layers=CARD_LAYERS)


def moe_preset(device) -> str:
    """The name of the MoE preset the MoE tool runs on ``device``."""
    import torch

    return CARD_MOE_PRESET if torch.device(device).type == "cuda" \
        else "tiny-moe"
