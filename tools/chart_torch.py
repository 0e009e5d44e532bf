#!/usr/bin/env python3
"""The chart as the PyTorch port's H100 install renders it.

``deployments/helm/tpu-dra-driver`` with ``values-h100.yaml``, rendered
by ``tools/helm_render.py`` after helm's own value coalescing (an overlay
that sets a key to null deletes the chart's default: the overlay drops
the TPU node label that way), and the names the rendered objects run
mapped to the port's entry points: the image
(``deployments/container/Dockerfile.torch``) links each chart command to
a ``-torch`` console script that ``pyproject.toml`` declares.

``tests/test_torch_deploy.py`` and ``chip_smoke.py``'s phase 45 read the
chart through these functions. ``python tools/chart_torch.py`` prints
the render, as ``helm template -f values-h100.yaml`` would.

It imports neither package.
"""

from __future__ import annotations

import re
import sys
import tomllib
from pathlib import Path

import yaml

ROOT = Path(__file__).resolve().parents[1]
CHART = ROOT / "deployments" / "helm" / "tpu-dra-driver"
OVERLAY = CHART / "values-h100.yaml"
DOCKERFILE = ROOT / "deployments" / "container" / "Dockerfile.torch"
sys.path.insert(0, str(ROOT / "tools"))

from helm_render import Renderer  # noqa: E402


def coalesce(base: dict, over: dict) -> dict:
    """helm's merge of user values over a chart's: maps merge key by key,
    anything else replaces, and a null deletes the key."""
    out = dict(base)
    for key, value in over.items():
        if value is None:
            out.pop(key, None)
        elif isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = coalesce(out[key], value)
        else:
            out[key] = value
    return out


def chart_values(overlay: Path | None = OVERLAY) -> dict:
    """The chart's values.yaml with ``overlay`` coalesced over it."""
    values = yaml.safe_load((CHART / "values.yaml").read_text())
    if overlay is None:
        return values
    return coalesce(values, yaml.safe_load(Path(overlay).read_text()))


def render(overlay: Path | None = OVERLAY) -> list:
    """Every object the chart renders with ``overlay`` (None: the
    defaults)."""
    renderer = Renderer(str(CHART))
    renderer.root_ctx["Values"] = chart_values(overlay)
    return renderer.objects()


def container(objs: list, kind: str) -> dict:
    """The one container of the chart's one ``kind`` workload
    (DaemonSet: the plugin; Deployment: the controller)."""
    (obj,) = [o for o in objs if o.get("kind") == kind]
    (ctr,) = obj["spec"]["template"]["spec"]["containers"]
    return ctr


def console_scripts() -> dict:
    """``pyproject.toml``'s console scripts: name -> "module:function"."""
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def image_commands() -> dict:
    """What each command name runs in the port's image: the image's
    links (``ln -sf <script> /usr/local/bin/<name>``) followed to the
    console script's "module:function"; the ENTRYPOINT under the key
    "ENTRYPOINT"."""
    text = DOCKERFILE.read_text()
    scripts = console_scripts()
    links = dict((name, target) for target, name in re.findall(
        r"ln -sf (\S+) /usr/local/bin/(\S+)", text))
    names = {name: scripts[target] for name, target in links.items()}
    (entry,) = re.findall(r'^ENTRYPOINT \["([^"]+)"\]', text, re.M)
    names["ENTRYPOINT"] = names.get(entry) or scripts[entry]
    return names


def main() -> int:
    for obj in render():
        print("---")
        print(yaml.safe_dump(obj, sort_keys=False).rstrip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
