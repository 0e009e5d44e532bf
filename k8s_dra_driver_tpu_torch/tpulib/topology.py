"""Accelerator generation specs and ICI topology math.

The port's copy of the reference module, with one more generation: the
NVIDIA H100 (``h100``), whose ``runtime`` is ``cuda``. A chip's runtime
picks the runtime-facing edits of a claim (device nodes, driver
libraries, visibility and sharing env; ``cdi/runtime.py``); the TPU rows
stay so the fake backend can replay every reference scenario.

This is the TPU-native replacement for the reference's GPU architecture /
CUDA-compute-capability attribute surface (nvlib.go:202-313 in
lengrongfu/k8s-dra-driver): instead of `architecture` + `cudaComputeCapability`
we model the things a scheduler (and a JAX workload) actually needs on TPU —
generation, cores per chip, HBM, peak FLOPs, and the chip's coordinates in the
ICI mesh, so that multi-chip claims can demand *contiguous sub-meshes* via
attribute selectors (the capability the reference deliberately skipped for
dynamic MIG, device_state.go:512).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator


@dataclasses.dataclass(frozen=True)
class GenerationSpec:
    """Static per-generation hardware description."""

    name: str                   # "v4", "v5e", "v5p", "v6e"
    cores_per_chip: int         # TensorCores per chip
    hbm_bytes: int
    # Peak dense bf16 FLOP/s per chip (both cores). Used by the workload layer
    # for MFU accounting and published as a capacity so schedulers can reason
    # about "how much compute" a claim grants.
    peak_bf16_flops: float
    # ICI mesh dimensionality: v4/v5p are 3D tori, v5e/v6e are 2D meshes;
    # 0 where the chips form no mesh (NVLink is a switch), so no
    # coordinate is ever published as ground truth.
    ici_dims: int
    # Whether two cores can be addressed as independent sub-chip devices
    # ("megacore" generations fuse them; pre-v4 and v5e expose one core/chip).
    partitionable: bool
    # The software stack a workload reaches the chip through: "libtpu"
    # (TPU_* env, /dev/accel*) or "cuda" (CUDA_VISIBLE_DEVICES,
    # /dev/nvidia*). Keys the mapping in cdi/runtime.py.
    runtime: str = "libtpu"


GENERATIONS: dict[str, GenerationSpec] = {
    "v2": GenerationSpec("v2", 2, 8 << 30, 45e12, 2, True),
    "v3": GenerationSpec("v3", 2, 16 << 30, 123e12, 2, True),
    "v4": GenerationSpec("v4", 2, 32 << 30, 275e12, 3, True),
    "v5e": GenerationSpec("v5e", 1, 16 << 30, 197e12, 2, False),
    "v5p": GenerationSpec("v5p", 2, 95 << 30, 459e12, 3, True),
    "v6e": GenerationSpec("v6e", 1, 32 << 30, 918e12, 2, False),
    # NVIDIA H100 SXM: one device per card, 80 GB nominal HBM (a real card
    # reports its own through NVML), 989 TFLOP/s dense bf16 (NVIDIA data
    # sheet). Partitionable through MIG: its partitions are the GPU
    # instances an admin created, which the chip library walks
    # (deviceinfo.MIG_PROFILES holds their profiles); no placement is
    # enumerated, so ``cores_per_chip`` stays 1.
    "h100": GenerationSpec("h100", 1, 80 << 30, 989e12, 0, True, "cuda"),
}


def runtime_of(generation: str) -> str:
    """The runtime a generation's chips are driven through; "libtpu" for
    a name outside the table, which the rest of the module treats as a
    TPU generation too."""
    spec = GENERATIONS.get(generation)
    return spec.runtime if spec is not None else "libtpu"


@dataclasses.dataclass(frozen=True, order=True)
class Coord:
    """Chip coordinate in the ICI mesh (z is 0 for 2D generations)."""

    x: int
    y: int
    z: int = 0

    def as_tuple(self) -> tuple[int, int, int]:
        return (self.x, self.y, self.z)

    def __str__(self) -> str:  # "1,2,0"
        return f"{self.x},{self.y},{self.z}"

    @classmethod
    def parse(cls, s: str) -> "Coord":
        parts = [int(p) for p in s.split(",")]
        while len(parts) < 3:
            parts.append(0)
        return cls(*parts[:3])


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Physical topology of a slice, e.g. 2x2x1 (v5e-4) or 4x4x4 (v5p-128)."""

    x: int
    y: int
    z: int = 1

    def __str__(self) -> str:
        return f"{self.x}x{self.y}x{self.z}"

    @classmethod
    def parse(cls, s: str) -> "MeshShape":
        parts = [int(p) for p in s.lower().split("x")]
        while len(parts) < 3:
            parts.append(1)
        return cls(*parts[:3])

    @property
    def num_chips(self) -> int:
        return self.x * self.y * self.z

    def coords(self) -> Iterator[Coord]:
        for x, y, z in itertools.product(
            range(self.x), range(self.y), range(self.z)
        ):
            yield Coord(x, y, z)

    def coord_at(self, index: int) -> Coord:
        """The index'th coordinate in ``coords()`` order (x outermost, z
        fastest) without materialising the iterator. This linearisation IS
        the coordinate contract: device index n on a host maps to the n'th
        cell of the host's chip block."""
        if not 0 <= index < self.num_chips:
            raise IndexError(f"index {index} outside {self}")
        yz = self.y * self.z
        return Coord(index // yz, (index % yz) // self.z, index % self.z)

    def index_of(self, c: Coord) -> int:
        """Inverse of ``coord_at``."""
        return (c.x * self.y + c.y) * self.z + c.z

    def divides(self, other: "MeshShape") -> bool:
        """True iff this shape tiles ``other`` exactly along every axis."""
        return (
            other.x % self.x == 0
            and other.y % self.y == 0
            and other.z % self.z == 0
        )

    def contains(self, c: Coord) -> bool:
        return 0 <= c.x < self.x and 0 <= c.y < self.y and 0 <= c.z < self.z


def is_contiguous_submesh(coords: list[Coord]) -> bool:
    """True iff `coords` form a dense axis-aligned box in the ICI mesh.

    This is the predicate behind gang allocation of multi-chip claims: a claim
    for N chips is only useful if the chips are an unbroken sub-mesh, because
    XLA's collective performance model assumes torus/mesh neighbours.  The
    scheduler enforces it via matchAttribute on the submesh id we publish; this
    helper is what the fake/real chiplibs and tests use to validate that.
    """
    if not coords:
        return False
    if len(set(coords)) != len(coords):
        return False
    xs = [c.x for c in coords]
    ys = [c.y for c in coords]
    zs = [c.z for c in coords]
    dims = (
        max(xs) - min(xs) + 1,
        max(ys) - min(ys) + 1,
        max(zs) - min(zs) + 1,
    )
    return dims[0] * dims[1] * dims[2] == len(coords)


def enumerate_submeshes(
    shape: MeshShape, sub: MeshShape
) -> Iterator[tuple[Coord, list[Coord]]]:
    """Yield (origin, member coords) for every axis-aligned `sub` box in `shape`.

    Used by the plugin to publish "submesh" attributes (the TPU analog of MIG
    placement enumeration, nvlib.go:244-295: for every profile, every placement
    it fits is advertised so the scheduler can pick a non-overlapping one).
    """
    for ox in range(shape.x - sub.x + 1):
        for oy in range(shape.y - sub.y + 1):
            for oz in range(shape.z - sub.z + 1):
                origin = Coord(ox, oy, oz)
                members = [
                    Coord(ox + dx, oy + dy, oz + dz)
                    for dx, dy, dz in itertools.product(
                        range(sub.x), range(sub.y), range(sub.z)
                    )
                ]
                yield origin, members


def box_shapes(volume: int, within: MeshShape) -> list[tuple[int, int, int]]:
    """Every axis-aligned box (dx, dy, dz) of exactly ``volume`` cells
    that fits inside ``within``, most-cubical first.

    This is the gang-shape enumeration behind the allocator's placement
    scorer and the defrag planner: a claim for N chips is satisfiable by
    any dense N-cell box, and trying compact shapes first keeps the ICI
    hop diameter (and therefore collective latency) low.
    """
    out = []
    for dx in range(1, min(volume, within.x) + 1):
        if volume % dx:
            continue
        rem = volume // dx
        for dy in range(1, min(rem, within.y) + 1):
            if rem % dy:
                continue
            dz = rem // dy
            if dz <= within.z:
                out.append((dx, dy, dz))
    out.sort(key=lambda d: (max(d) - min(d), d))
    return out


def free_components(free: set[tuple[int, int, int]]) -> list[set[tuple[int, int, int]]]:
    """Connected components of the free cell set under ICI adjacency
    (6-neighbour). The component a placement lands in is the scorer's
    best-fit unit: packing a gang into the smallest component that still
    fits it preserves the larger components for future large gangs."""
    seen: set[tuple[int, int, int]] = set()
    comps = []
    for start in free:
        if start in seen:
            continue
        comp = set()
        stack = [start]
        seen.add(start)
        while stack:
            x, y, z = stack.pop()
            comp.add((x, y, z))
            for nb in ((x + 1, y, z), (x - 1, y, z), (x, y + 1, z),
                       (x, y - 1, z), (x, y, z + 1), (x, y, z - 1)):
                if nb in free and nb not in seen:
                    seen.add(nb)
                    stack.append(nb)
        comps.append(comp)
    return comps


def largest_free_submesh(
    shape: MeshShape, free: set[tuple[int, int, int]]
) -> int:
    """Volume of the largest fully-free axis-aligned box in ``shape``.

    The fleet fragmentation metric: under churn this number decays even
    while total free capacity stays flat, and it bounds the largest gang
    claim that can still be satisfied without defragmentation. Uses a 3D
    prefix sum so every (dims, origin) probe is O(1); total cost is
    O(|dims| * |origins|), fine for per-slice meshes.
    """
    if not free:
        return 0
    nx, ny, nz = shape.x, shape.y, shape.z
    # p[x][y][z] = free cells in the [0,x) x [0,y) x [0,z) prefix box.
    p = [[[0] * (nz + 1) for _ in range(ny + 1)] for _ in range(nx + 1)]
    for x in range(nx):
        for y in range(ny):
            row = p[x + 1][y + 1]
            prow = p[x][y + 1]
            srow = p[x + 1][y]
            drow = p[x][y]
            for z in range(nz):
                row[z + 1] = (
                    (1 if (x, y, z) in free else 0)
                    + prow[z + 1] + srow[z + 1] + row[z]
                    - drow[z + 1] - prow[z] - srow[z] + drow[z]
                )

    def box_free(ox, oy, oz, dx, dy, dz) -> bool:
        x1, y1, z1 = ox + dx, oy + dy, oz + dz
        total = (
            p[x1][y1][z1] - p[ox][y1][z1] - p[x1][oy][z1] - p[x1][y1][oz]
            + p[ox][oy][z1] + p[ox][y1][oz] + p[x1][oy][oz] - p[ox][oy][oz]
        )
        return total == dx * dy * dz

    best = 1  # free is non-empty, so a 1-cell box always exists
    for dx in range(1, nx + 1):
        for dy in range(1, ny + 1):
            for dz in range(1, nz + 1):
                vol = dx * dy * dz
                if vol <= best or vol > len(free):
                    continue
                hit = False
                for ox in range(nx - dx + 1):
                    for oy in range(ny - dy + 1):
                        for oz in range(nz - dz + 1):
                            if box_free(ox, oy, oz, dx, dy, dz):
                                best = vol
                                hit = True
                                break
                        if hit:
                            break
                    if hit:
                        break
    return best


def default_slice_shapes(generation: str, num_chips: int) -> MeshShape:
    """Best-effort physical shape for a slice of `num_chips` chips."""
    spec = GENERATIONS.get(generation, GENERATIONS["v4"])
    if spec.ici_dims == 0:
        return MeshShape(num_chips, 1, 1)
    if spec.ici_dims == 2:
        # Square-ish 2D mesh.
        x = 1
        for cand in range(1, int(num_chips**0.5) + 1):
            if num_chips % cand == 0:
                x = cand
        return MeshShape(x, num_chips // x, 1)
    # 3D torus: cube-ish factorisation.
    best = (1, 1, num_chips)
    for x in range(1, num_chips + 1):
        if num_chips % x:
            continue
        rem = num_chips // x
        for y in range(1, rem + 1):
            if rem % y:
                continue
            z = rem // y
            cand = tuple(sorted((x, y, z)))
            if max(cand) - min(cand) < max(best) - min(best):
                best = cand
    return MeshShape(*best)
