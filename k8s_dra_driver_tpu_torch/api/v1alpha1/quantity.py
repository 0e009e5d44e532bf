"""Kubernetes resource.Quantity parsing (subset).

The reference uses apimachinery's resource.Quantity for MPS pinned-memory
limits (lengrongfu/k8s-dra-driver,
api/nvidia.com/resource/gpu/v1alpha1/sharing.go:81-89, :190-273). We need the
same for per-chip HBM limits: parse "16Gi"/"4G"/"512Mi"/plain ints to bytes,
and render the canonical "<N>M" (MiB) wire form the sharing config normalizes
to.
"""

from __future__ import annotations

import re

_BINARY = {"Ki": 1 << 10, "Mi": 1 << 20, "Gi": 1 << 30,
           "Ti": 1 << 40, "Pi": 1 << 50, "Ei": 1 << 60}
_DECIMAL = {"k": 10**3, "M": 10**6, "G": 10**9,
            "T": 10**12, "P": 10**15, "E": 10**18}

_QUANTITY_RE = re.compile(
    r"^(?P<num>[+-]?[0-9]+(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?)"
    r"(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|k|M|G|T|P|E)?$"
)


class InvalidQuantityError(ValueError):
    pass


def parse_quantity(s: str | int | float) -> int:
    """Parse a quantity to integer bytes (rounding down)."""
    if isinstance(s, (int, float)):
        return int(s)
    s = str(s).strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise InvalidQuantityError(f"invalid quantity: {s!r}")
    num = float(m.group("num"))
    suffix = m.group("suffix")
    mult = 1
    if suffix:
        mult = _BINARY.get(suffix) or _DECIMAL.get(suffix)
    return int(num * mult)


def to_mebibytes_string(nbytes: int) -> str:
    """Canonical normalized wire form: whole MiB as "<N>M" is ambiguous with
    the decimal suffix, so we use "<N>Mi" explicitly. Rounds UP so a
    validated-positive sub-MiB limit never normalizes to a zero cap."""
    return f"{(nbytes + (1 << 20) - 1) // (1 << 20)}Mi"
