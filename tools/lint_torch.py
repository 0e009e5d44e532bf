#!/usr/bin/env python3
"""The lint gate of the PyTorch port (``make lint-torch``).

Its own copy of ``tools/lint.py``'s checks (a twin imports no reference
tool), run over the port's files: ``k8s_dra_driver_tpu_torch/``,
``chip_smoke.py``, ``_decodebench_torch.py``,
``demo/run_demo_sim_torch.py`` and the ``tools/*_torch.py`` twins.

- F401 (not in ``__init__.py``), F811, F841, E722, B006, E711, E712: the
  pyflakes-core floor, as ``tools/lint.py`` approximates ruff's rules.
- TPM01-TPM05: the metric naming contract (``tpu_dra_`` prefix, unit
  suffixes, help text, per-chip labels only in ``plugin/accounting.py``
  and ``plugin/audit.py``, each family in its home module or directory),
  applied under ``k8s_dra_driver_tpu_torch/``.
- TPM06: ``stage=``/``reason=`` values on the ``tpu_dra_alloc_*``
  families confined to the ``STAGES``/``REASONS`` enums of the port's
  ``kube/allocator.py`` (parsed by AST); computed values only inside that
  file.

Usage: ``python tools/lint_torch.py [PATH ...]`` from the repo root.
Exit status 1 when any finding is emitted.
"""

from __future__ import annotations

import ast
import functools
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "k8s_dra_driver_tpu_torch"


class Finding:
    def __init__(self, path: Path, line: int, code: str, msg: str):
        self.path, self.line, self.code, self.msg = path, line, code, msg

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.msg}"


def _names_loaded(tree: ast.AST) -> set[str]:
    """Every identifier read anywhere in the tree (incl. attribute roots),
    plus names referenced in string annotations and __all__ exports."""
    loaded: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            loaded.add(node.id)
        elif isinstance(node, ast.Attribute):
            root = node
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                loaded.add(root.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # String annotations / __all__ entries keep imports "used".
            if node.value.isidentifier():
                loaded.add(node.value)
    return loaded


def check_unused_imports(tree: ast.Module, path: Path) -> list[Finding]:
    out = []
    loaded = _names_loaded(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                if name not in loaded:
                    out.append(Finding(
                        path, node.lineno, "F401",
                        f"{alias.name!r} imported but unused"))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                name = alias.asname or alias.name
                if name not in loaded:
                    out.append(Finding(
                        path, node.lineno, "F401",
                        f"{alias.name!r} imported but unused"))
    return out


def check_redefinitions(tree: ast.Module, path: Path) -> list[Finding]:
    out = []
    seen: dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # @overload / @property chains and conditional defs are the
            # legitimate uses; only flag unconditional same-scope dupes
            # without decorators.
            if node.decorator_list:
                continue
            if node.name in seen:
                out.append(Finding(
                    path, node.lineno, "F811",
                    f"redefinition of {node.name!r} from line "
                    f"{seen[node.name]}"))
            seen[node.name] = node.lineno
    return out


def check_function_bodies(tree: ast.Module, path: Path) -> list[Finding]:
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for default in (fn.args.defaults + fn.args.kw_defaults):
            if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                out.append(Finding(
                    path, default.lineno, "B006",
                    "mutable default argument"))
        # F841: names assigned in this function's OWN scope, never loaded.
        # ast.walk can't prune subtrees, so gather assigns with an explicit
        # stack that stops at nested function/class scopes (a nested class
        # body is its own scope: `prefix = ...` there is a class attribute,
        # not a local of the enclosing function).
        assigned: dict[str, int] = {}
        stack: list[ast.AST] = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) \
                            and not tgt.id.startswith("_"):
                        assigned.setdefault(tgt.id, tgt.lineno)
            stack.extend(ast.iter_child_nodes(node))
        loaded = _names_loaded(fn)
        # Stores count too conservatively: augmented assigns and nested
        # scopes read names ast.Name/Load won't attribute here; only
        # report when the name appears exactly once in the whole function.
        for name, lineno in assigned.items():
            occurrences = sum(
                1 for n in ast.walk(fn)
                if isinstance(n, ast.Name) and n.id == name
            )
            if name not in loaded and occurrences == 1:
                out.append(Finding(
                    path, lineno, "F841",
                    f"local variable {name!r} assigned but never used"))
    return out


def check_misc(tree: ast.Module, path: Path) -> list[Finding]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            out.append(Finding(path, node.lineno, "E722", "bare except"))
        elif isinstance(node, ast.Compare):
            for op, cmp_ in zip(node.ops, node.comparators):
                if not isinstance(op, (ast.Eq, ast.NotEq)):
                    continue
                if isinstance(cmp_, ast.Constant):
                    if cmp_.value is None:
                        out.append(Finding(
                            path, node.lineno, "E711",
                            "comparison to None should be 'is None'"))
                    elif cmp_.value is True or cmp_.value is False:
                        out.append(Finding(
                            path, node.lineno, "E712",
                            "comparison to True/False should use 'is'"))
    return out


_METRIC_CLASSES = {"Counter", "Gauge", "Histogram"}
_METRIC_PREFIX = "tpu_dra_"
# _total is a counter-only suffix (it would collide with histogram series
# naming), so histograms get the unit suffixes without it.
_HISTOGRAM_UNIT_SUFFIXES = ("_seconds", "_bytes", "_celsius", "_ratio",
                            "_ops", "_blocks")
# TPM04: label names whose values scale with the device inventory, and
# the only modules allowed to emit them (their series counts are bounded
# by the node's chip count by construction).
_PER_CHIP_LABELS = {"chip", "uuid", "device"}
_PER_CHIP_LABEL_MODULES = {"accounting.py", "audit.py"}
# TPM05: module-owned family prefixes. allocator.py's prefix is the
# shared stem of its two families (tpu_dra_alloc_* explainability +
# tpu_dra_allocation_* attempt/backtrack counters); defrag.py owns the
# planner's tpu_dra_defrag_* families.
_MODULE_FAMILY_PREFIXES = {
    "accounting.py": "tpu_dra_usage_",
    "audit.py": "tpu_dra_audit_",
    "elastic.py": "tpu_dra_elastic_",
    "allocator.py": "tpu_dra_alloc",
    "defrag.py": "tpu_dra_defrag_",
    # The executor's tpu_dra_defrag_exec_* family shares the planner's
    # stem deliberately (one dashboard groups plan + execution); the
    # module entry keeps declaration ownership separate.
    "defrag_executor.py": "tpu_dra_defrag_exec_",
    "rebalancer.py": "tpu_dra_slo_",
    # reqtrace.py and residency.py live under serving_gateway/ but own
    # their own families; a module entry exempts them from the
    # directory rule below.
    "reqtrace.py": "tpu_dra_srv_",
    "residency.py": "tpu_dra_residency_",
    # The KV lifecycle family: paged.py holds the plain-int ledger,
    # serving.py's KVTelemetry declares the exported series.
    "paged.py": "tpu_dra_kv_",
    "serving.py": "tpu_dra_kv_",
    # The compute-plane family: compute_telemetry.py owns the catalog,
    # collectives.py declares the collective counters beside their
    # site vocabulary — the same two-owner split as tpu_dra_kv_.
    "compute_telemetry.py": "tpu_dra_compute_",
    "collectives.py": "tpu_dra_compute_",
}
# Directory-owned families: every metric declared anywhere under the
# directory uses its prefix, and (unlike the per-module table, whose
# filenames are unique) the prefix is also confined TO the directory —
# the serving gateway spans several modules (router/admission/
# autoscaler/gateway) that share one family.
_DIR_FAMILY_PREFIXES = {
    "serving_gateway": "tpu_dra_gw_",
    "fleetsim": "tpu_dra_fleet_",
}
# Module-owned prefixes confined BOTH directions (like the directory
# rule), keyed prefix -> owner set: tpu_dra_srv_* declared anywhere but
# reqtrace.py is a vocabulary leak; tpu_dra_kv_* has TWO legitimate
# owners (the paged pool's ledger and the serving engine's exporter).
# Only unambiguous prefixes belong here — tpu_dra_alloc is a shared
# stem (tpu_dra_alloc_* + tpu_dra_allocation_*), so it stays
# declare-side-only in _MODULE_FAMILY_PREFIXES.
_CONFINED_MODULE_PREFIXES = {
    "tpu_dra_srv_": frozenset({"reqtrace.py"}),
    "tpu_dra_kv_": frozenset({"paged.py", "serving.py"}),
    "tpu_dra_residency_": frozenset({"residency.py"}),
    "tpu_dra_compute_": frozenset(
        {"compute_telemetry.py", "collectives.py"}
    ),
}
_METRIC_METHODS = {"inc", "set", "observe"}


def check_metric_conventions(tree: ast.Module, path: Path) -> list[Finding]:
    """First-party metric naming floor: every Counter/Gauge/Histogram
    instantiation in driver code uses the tpu_dra_ prefix, a unit suffix
    appropriate to its kind, and non-empty help text."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        cls = None
        if isinstance(func, ast.Name) and func.id in _METRIC_CLASSES:
            cls = func.id
        elif (isinstance(func, ast.Attribute)
                and func.attr in _METRIC_CLASSES):
            cls = func.attr
        if cls is None or not node.args:
            continue
        name_arg = node.args[0]
        if not (isinstance(name_arg, ast.Constant)
                and isinstance(name_arg.value, str)):
            continue  # e.g. collections.Counter(), or a computed name
        name = name_arg.value
        if not name.startswith(_METRIC_PREFIX):
            out.append(Finding(
                path, node.lineno, "TPM01",
                f"{cls} name {name!r} lacks the {_METRIC_PREFIX!r} prefix"))
        if cls == "Counter" and not name.endswith("_total"):
            out.append(Finding(
                path, node.lineno, "TPM02",
                f"Counter name {name!r} must end with '_total'"))
        if cls == "Histogram" and not name.endswith(_HISTOGRAM_UNIT_SUFFIXES):
            out.append(Finding(
                path, node.lineno, "TPM02",
                f"Histogram name {name!r} must carry a unit suffix "
                f"({', '.join(_HISTOGRAM_UNIT_SUFFIXES)})"))
        help_arg = node.args[1] if len(node.args) > 1 else None
        if (isinstance(help_arg, ast.Constant)
                and isinstance(help_arg.value, str)
                and not help_arg.value.strip()):
            out.append(Finding(
                path, node.lineno, "TPM03",
                f"{cls} {name!r} has empty help text"))
        owned_prefix = _MODULE_FAMILY_PREFIXES.get(path.name)
        if owned_prefix and not name.startswith(owned_prefix):
            out.append(Finding(
                path, node.lineno, "TPM05",
                f"{cls} name {name!r} declared in {path.name} must use "
                f"the {owned_prefix!r} family prefix"))
        for mod_prefix, owners in _CONFINED_MODULE_PREFIXES.items():
            if path.name not in owners and name.startswith(mod_prefix):
                out.append(Finding(
                    path, node.lineno, "TPM05",
                    f"{cls} name {name!r} uses the {mod_prefix!r} "
                    f"family prefix owned by "
                    f"{'/'.join(sorted(owners))}"))
        for dirname, dir_prefix in _DIR_FAMILY_PREFIXES.items():
            in_dir = dirname in path.parts
            # A file with its own module-owned family is exempt from its
            # directory's declare-side rule (reqtrace.py under
            # serving_gateway/ declares tpu_dra_srv_*, not tpu_dra_gw_*)
            # — but never from the confinement arm below.
            if in_dir and path.name in _MODULE_FAMILY_PREFIXES:
                continue
            if in_dir and not name.startswith(dir_prefix):
                out.append(Finding(
                    path, node.lineno, "TPM05",
                    f"{cls} name {name!r} declared under {dirname}/ "
                    f"must use the {dir_prefix!r} family prefix"))
            elif not in_dir and name.startswith(dir_prefix):
                out.append(Finding(
                    path, node.lineno, "TPM05",
                    f"{cls} name {name!r} uses the {dir_prefix!r} "
                    f"family prefix owned by {dirname}/"))
    return out


# TPM06: the alloc explainability families and their enum'd labels.
_ALLOC_FAMILY_PREFIX = "tpu_dra_alloc"
_ALLOC_ENUM_LABELS = {"stage": "STAGES", "reason": "REASONS"}
_ALLOC_ENUMS_PATH = ROOT / PACKAGE / "kube" / "allocator.py"


@functools.cache
def _alloc_enums() -> dict[str, frozenset[str]]:
    """{label name: allowed values} parsed from allocator.py's module-level
    STAGES/REASONS tuple literals. Empty sets when the file or a tuple is
    missing — the caller reports that as its own finding rather than
    silently passing everything."""
    values: dict[str, frozenset[str]] = {
        label: frozenset() for label in _ALLOC_ENUM_LABELS
    }
    try:
        tree = ast.parse(_ALLOC_ENUMS_PATH.read_text())
    except OSError:
        return values
    wanted = set(_ALLOC_ENUM_LABELS.values())
    # Module-level string constants (STAGE_GANG = "gang", ...), so enum
    # tuples may list either literals or those names.
    consts: dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    consts[tgt.id] = node.value.value
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if not (isinstance(tgt, ast.Name) and tgt.id in wanted):
                continue
            if isinstance(node.value, (ast.Tuple, ast.List)):
                vals = set()
                for el in node.value.elts:
                    if isinstance(el, ast.Constant) \
                            and isinstance(el.value, str):
                        vals.add(el.value)
                    elif isinstance(el, ast.Name) and el.id in consts:
                        vals.add(consts[el.id])
                for label, enum_name in _ALLOC_ENUM_LABELS.items():
                    if enum_name == tgt.id:
                        values[label] = frozenset(vals)
    return values


def _receiver_name(node: ast.AST) -> str:
    """Terminal identifier of a metric receiver: ``self._m_unsat`` and
    ``alloc._m_unsat`` both read ``_m_unsat``; a bare Name reads as is."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def check_alloc_label_enums(tree: ast.Module, path: Path) -> list[Finding]:
    """TPM06: stage/reason label values on tpu_dra_alloc_* metrics are
    confined to allocator.py's declared enums."""
    # Metric objects bound from a constructor whose family name is
    # tpu_dra_alloc_*: {terminal receiver name}.
    alloc_receivers: set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        func = node.value.func
        cls = func.id if isinstance(func, ast.Name) else (
            func.attr if isinstance(func, ast.Attribute) else "")
        if cls not in _METRIC_CLASSES or not node.value.args:
            continue
        name_arg = node.value.args[0]
        if not (isinstance(name_arg, ast.Constant)
                and isinstance(name_arg.value, str)
                and name_arg.value.startswith(_ALLOC_FAMILY_PREFIX)):
            continue
        for tgt in node.targets:
            recv = _receiver_name(tgt)
            if recv:
                alloc_receivers.add(recv)
    if not alloc_receivers:
        return []
    enums = _alloc_enums()
    out = []
    if any(not vals for vals in enums.values()):
        out.append(Finding(
            path, 1, "TPM06",
            f"cannot resolve {sorted(_ALLOC_ENUM_LABELS.values())} tuple "
            f"literals in {_ALLOC_ENUMS_PATH} — the alloc label enums the "
            "stage/reason labels are confined to"))
        return out
    # Full-path comparison: another allocator.py must not inherit the
    # computed-label exemption.
    in_allocator = path.resolve() == _ALLOC_ENUMS_PATH.resolve()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in _METRIC_METHODS
                and _receiver_name(func.value) in alloc_receivers):
            continue
        for kw in node.keywords:
            allowed = enums.get(kw.arg or "")
            if allowed is None:
                continue
            if isinstance(kw.value, ast.Constant):
                if kw.value.value not in allowed:
                    out.append(Finding(
                        path, node.lineno, "TPM06",
                        f"label {kw.arg}={kw.value.value!r} not in "
                        f"allocator.py's {_ALLOC_ENUM_LABELS[kw.arg]} "
                        "enum"))
            elif not in_allocator:
                out.append(Finding(
                    path, node.lineno, "TPM06",
                    f"computed {kw.arg!r} label on a tpu_dra_alloc_* "
                    "metric outside kube/allocator.py — enum confinement "
                    "cannot be checked"))
    return out


def check_per_chip_labels(tree: ast.Module, path: Path) -> list[Finding]:
    """TPM04: per-chip metric labels only where series counts are bounded
    by the node's device inventory (accounting.py / audit.py)."""
    if path.name in _PER_CHIP_LABEL_MODULES:
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in _METRIC_METHODS):
            continue
        for kw in node.keywords:
            if kw.arg in _PER_CHIP_LABELS:
                out.append(Finding(
                    path, node.lineno, "TPM04",
                    f"per-chip label {kw.arg!r} on .{func.attr}() outside "
                    f"{sorted(_PER_CHIP_LABEL_MODULES)} — unbounded label "
                    "cardinality"))
    return out


def lint_file(path: Path) -> list[Finding]:
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "E999", f"syntax error: {e.msg}")]
    out = []
    # __init__.py files are re-export surfaces; like ruff's conventional
    # per-file-ignores (`"__init__.py" = ["F401"]`), unused-import does
    # not apply there.
    if path.name != "__init__.py":
        out += check_unused_imports(tree, path)
    out += check_redefinitions(tree, path)
    out += check_function_bodies(tree, path)
    out += check_misc(tree, path)
    # Metric naming applies to the package only: tools mint
    # deliberately odd names to exercise the renderer.
    if PACKAGE in path.resolve().parts:
        out += check_metric_conventions(tree, path)
        out += check_per_chip_labels(tree, path)
        out += check_alloc_label_enums(tree, path)
    return out


def default_roots() -> list[Path]:
    """The port's files, relative to the working directory when it is the
    repo root (as ``make lint-torch`` runs it)."""
    roots = [ROOT / PACKAGE, ROOT / "chip_smoke.py",
             ROOT / "_decodebench_torch.py",
             ROOT / "demo" / "run_demo_sim_torch.py",
             *sorted((ROOT / "tools").glob("*_torch.py"))]
    cwd = Path.cwd().resolve()
    return [p.relative_to(cwd) if p.is_relative_to(cwd) else p
            for p in roots]


def main(argv: list[str]) -> int:
    roots = [Path(a) for a in argv] or default_roots()
    files: list[Path] = []
    for root in roots:
        if root.is_dir():
            files += sorted(root.rglob("*.py"))
        else:
            files.append(root)
    findings: list[Finding] = []
    for f in files:
        if "_pb2" in f.name:  # generated protobuf descriptor modules
            continue
        findings += lint_file(f)
    for fd in findings:
        print(fd)
    print(f"lint: {len(files)} files, {len(findings)} findings",
          file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
