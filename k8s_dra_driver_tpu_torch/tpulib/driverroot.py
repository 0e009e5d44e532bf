"""Driver-root resolution: locate the GPU driver's files under a
configured root.

The port's copy of the reference module (``tpulib/driverroot.py``),
retargeted from libtpu to the NVIDIA driver. Role of the reference's root
type (lengrongfu/k8s-dra-driver, cmd/nvidia-dra-plugin/root.go:25-107):
the driver's files may live on the host filesystem (mounted into the
plugin container) rather than in the plugin's image, so a root is a
prefix under which a fixed list of well-known directories is searched for
each driver file, chasing symlinks WITHIN the root (chroot-style); a root
containing a dev/ directory is a "dev root" usable for device nodes
(root.go:64-81).

Two paths describe the same directory: ``root`` is where the plugin
CONTAINER sees the mount (where the search runs), ``host_root`` is the
HOST path of that directory (what goes into CDI ``hostPath`` fields, which
the container runtime resolves in the host mount namespace).

The files searched for:

- ``libcuda.so.1`` and ``libnvidia-ml.so.1`` -- the driver's user-space
  libraries, which CUDA and NVML load; a claim's CDI spec mounts the ones
  found into the workload container (``cdi/runtime.py``);
- ``nvidia-smi`` -- the diagnostic CLI, surfaced for debugging;
- ``libtpu.so``, for the TPU generations the fake backend still models:
  the claim spec of a ``libtpu`` chip mounts it as the reference's does.

The libtpu-wheel globs of the reference's search list are gone; the
system paths and the link-escape guard are the same.
"""

from __future__ import annotations

import dataclasses
import glob
import os

# Well-known library directories, relative to the root (root.go:30-37).
LIBRARY_SEARCH_PATHS = [
    "usr/lib64",
    "usr/lib/x86_64-linux-gnu",
    "usr/lib/aarch64-linux-gnu",
    "lib64",
    "lib/x86_64-linux-gnu",
    "lib/aarch64-linux-gnu",
    "usr/local/lib",
]

# The driver libraries a CUDA workload loads (libcuda through the CUDA
# runtime, libnvidia-ml through NVML).
DRIVER_LIBRARIES = ("libcuda.so.1", "libnvidia-ml.so.1")

# Binary search directories (root.go:49-55 analog).
BINARY_SEARCH_PATHS = [
    "usr/bin",
    "usr/sbin",
    "bin",
    "sbin",
    "usr/local/bin",
]


class DriverRootError(FileNotFoundError):
    """A driver file was not found under the root."""


@dataclasses.dataclass(frozen=True)
class DriverRoot:
    """A filesystem prefix containing the GPU driver installation.

    ``root`` — the prefix as visible to THIS process (the plugin
    container's mount of the host directory).
    ``host_root`` — the same directory's path on the host; defaults to
    ``root`` (correct when running unconfined on the host itself).
    """

    root: str = "/"
    host_root: str | None = None

    # -- symlink handling --------------------------------------------------

    def _resolve_link(self, path: str, max_hops: int = 16) -> str:
        """Chase symlinks chroot-style: the link target — absolute, or
        relative with ``..`` chains — is interpreted as if the root were
        ``/``. posixpath.normpath clamps ``/../`` at ``/``, so a target
        like ``../../../../usr/lib/libcuda.so.1`` cannot escape into the
        plugin container's own filesystem (and then be emitted as a bogus
        CDI hostPath)."""
        # Virtual (in-root) view of the path.
        v = "/" + os.path.relpath(path, self.root)
        for _ in range(max_hops):
            real = os.path.join(self.root, v.lstrip("/"))
            if not os.path.islink(real):
                return real
            target = os.readlink(real)
            if not os.path.isabs(target):
                target = os.path.join(os.path.dirname(v), target)
            v = os.path.normpath(target)
        raise DriverRootError(f"symlink loop resolving {path!r}")

    # -- layered search (findFile analog, root.go:84-107) ------------------

    def find_file(self, name: str, search_in: list[str]) -> str:
        """Search the root itself plus each listed directory (glob
        patterns allowed) for `name`; resolve symlinks; return the first
        regular file found (container-visible path)."""
        for rel in ["", *search_in]:
            pattern = os.path.join(self.root, rel, name)
            for candidate in sorted(glob.glob(pattern)):
                try:
                    resolved = self._resolve_link(candidate)
                except DriverRootError:
                    continue
                if os.path.isfile(resolved):
                    return resolved
        raise DriverRootError(
            f"{name!r} not found under driver root {self.root!r}"
        )

    def find_library(self, name: str) -> str:
        return self.find_file(name, LIBRARY_SEARCH_PATHS)

    def find_binary(self, name: str = "nvidia-smi") -> str:
        return self.find_file(name, BINARY_SEARCH_PATHS)

    # -- container -> host translation -------------------------------------

    def to_host_path(self, path: str) -> str:
        """Translate a path found under ``root`` into the host mount
        namespace, where the container runtime resolves CDI hostPaths."""
        hroot = self.host_root if self.host_root is not None else self.root
        rel = os.path.relpath(path, self.root)
        if rel.startswith(".."):
            raise DriverRootError(
                f"{path!r} is not under driver root {self.root!r}"
            )
        return os.path.normpath(os.path.join(hroot, rel))

    # -- dev root (root.go:64-81 analog) -----------------------------------

    def is_dev_root(self) -> bool:
        return os.path.isdir(os.path.join(self.root, "dev"))

    def dev_root(self) -> str:
        """The dev root associated with this root: itself if it contains a
        dev/ directory, else the container's own /."""
        return self.root if self.is_dev_root() else "/"

    # -- workload wiring ---------------------------------------------------

    def libtpu_or_none(self) -> str | None:
        try:
            return self.find_library("libtpu.so")
        except DriverRootError:
            return None

    def driver_libraries(self) -> dict[str, str]:
        """{name: container-visible path} of each driver library found;
        the ones the root lacks are left out."""
        out = {}
        for name in DRIVER_LIBRARIES:
            try:
                out[name] = self.find_library(name)
            except DriverRootError:
                continue
        return out
