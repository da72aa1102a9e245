"""AST-based repo-invariant lints over ``src/repro_torch/`` -- the JAX
package's rules R1-R7 (``repro.analysis.lint_rules``), with the same rule
names, restated for eager PyTorch.  JAX traces a ``custom_vjp`` body or a
Pallas kernel; eager torch has no trace, and what a traced body was there
is the ``forward``/``backward`` of a ``torch.autograd.Function`` here: the
code every differentiated product runs, once per call.

* **R1 traced-numpy** -- nothing reachable (same-module call graph: calls
  of module-level functions by name, and of same-module methods by
  attribute) from a ``Function``'s ``forward``/``backward`` makes the host
  wait for the card or leave the tensor world: no ``.item()``,
  ``.tolist()``, ``.cpu()`` or ``.numpy()``, no ``numpy`` call, no
  ``torch.cuda.synchronize``.  Each one stalls the launch queue the
  kernels are fed from.  Anything behind an ``lru_cache`` boundary is
  excluded (host memoization: computed once).  The JAX rule's ``float0``
  exclusion (zero cotangents of integer residuals) has no twin: a torch
  ``backward`` returns ``None`` there.  The rule finds no such call on
  today's tree, so it has no allowlist.
* **R2 lru-cache-static** -- ``lru_cache`` only on hashable-static
  signatures: no mutable-literal defaults, no parameter annotated with a
  known-unhashable type (list/dict/set/ndarray).
* **R3 custom-vjp-pairing** -- every ``torch.autograd.Function`` defines
  ``forward`` and ``backward`` as staticmethods; ``backward`` takes
  ``ctx`` plus one gradient per output of a literal-tuple ``forward``
  return, and each literal-tuple return of ``backward`` holds one
  gradient (or ``None``) per ``forward`` input after ``ctx``.  Computed
  and starred returns are skipped, not guessed, as in the JAX rule.
* **R4 static-aux-frozen** -- dataclasses that act as static metadata or
  cache keys (names ending Meta/Spec/Config/Fingerprint/Choice/Variant/
  Cell) must be ``frozen=True`` with no unhashable field annotations.
* **R5 fingerprint-fields** -- every dispatch-relevant ``ops.SparseMeta``
  field is read by ``autotune.fingerprint``, and every ``Fingerprint``
  field (``device`` included) is rendered by ``key()``.
* **R6 package-facade** -- every name in ``repro_torch/__init__.py``'s
  literal ``__all__`` resolves on ``import repro_torch``.
* **R7 obs-host-only** -- no ``repro_torch.obs`` call reachable (R1's
  call graph) from a ``Function``'s ``forward``/``backward``, and the
  kernel wrappers (``KERNEL_WRAPPERS``) import no obs module: a span or
  event belongs around a product, not inside the code its gradient runs.
  The obs package itself is skipped.

``lint_source`` runs R1-R4 and R7 on one module; ``lint_tree`` runs
everything (R5 needs ops.py + autotune.py together; R6 runs when the
tree is the ``repro_torch`` package) and is what the CLI gates on.

>>> fs = lint_source("import functools\\n"
...                  "@functools.lru_cache(maxsize=None)\\n"
...                  "def f(xs: list): return sum(xs)\\n", "x.py")
>>> [f.rule for f in fs]
['lru-cache-static']
"""
from __future__ import annotations

import ast
import os
import re

from repro_torch.analysis.report import Finding

RULES = ("traced-numpy", "lru-cache-static", "custom-vjp-pairing",
         "static-aux-frozen", "fingerprint-fields", "package-facade",
         "obs-host-only")

# dataclasses with these name suffixes are static metadata: cache keys,
# dispatch specs, memoization arguments
_STATIC_AUX_RE = re.compile(
    r".*(Meta|Spec|Config|Fingerprint|Choice|Variant|Cell)$")

_UNHASHABLE_NAMES = {"list", "List", "dict", "Dict", "set", "Set",
                     "ndarray", "bytearray", "MutableMapping"}

# SparseMeta fields that are legitimately absent from the fingerprint:
# ``shape`` is determined by (n_block_rows, n_block_cols, block) up to
# ragging the N-bucket already captures; ``nnzb_t`` is derived transpose
# bookkeeping, not a dispatch dimension.
FINGERPRINT_FIELD_ALLOWLIST = frozenset({"shape", "nnzb_t"})

# R1: host calls that leave the tensor world or wait for the card
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
SYNC_CALLS = frozenset({"torch.cuda.synchronize"})

# R7: the kernel wrappers, which import no obs module
KERNEL_WRAPPERS = frozenset({"bcsr_spmm.py", "bcsr_attn.py", "ref.py",
                             "_build.py"})
_OBS = "repro_torch.obs"


# ----------------------------------------------------------- AST utilities
def _dotted(node):
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _dec_name(dec):
    """Dotted name of a decorator, unwrapping a call: ``@x.y(...)`` -> x.y."""
    return _dotted(dec.func if isinstance(dec, ast.Call) else dec)


def _is_lru(func_def) -> bool:
    return any((_dec_name(d) or "").endswith("lru_cache")
               for d in func_def.decorator_list)


def _arity(func_def):
    """Positional arity, or None when *args makes it open-ended."""
    a = func_def.args
    if a.vararg is not None:
        return None
    return len(a.posonlyargs) + len(a.args)


def _all_args(func_def):
    a = func_def.args
    return list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)


def _ann_unhashable(ann) -> bool:
    for node in ast.walk(ann):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name in _UNHASHABLE_NAMES:
            return True
    return False


def _literal_tuple_len(node):
    """Length of a literal tuple with no starred element, else None."""
    if isinstance(node, ast.Tuple) and \
            not any(isinstance(e, ast.Starred) for e in node.elts):
        return len(node.elts)
    return None


def _returns(func_def):
    """The ``return <value>`` statements of a function's own body (not of
    the functions and lambdas nested in it)."""
    out, stack = [], list(func_def.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Return) and node.value is not None:
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def autograd_functions(tree: ast.Module):
    """The ``torch.autograd.Function`` subclasses of a module: classes
    with a base whose dotted name ends in ``Function``."""
    return [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
            and any((_dotted(b) or "").endswith("Function")
                    for b in n.bases)]


def autograd_bodies(tree: ast.Module):
    """``(class name, method name, FunctionDef)`` of every ``forward`` and
    ``backward`` of the module's autograd Functions: the roots of R1 and
    R7."""
    return [(cls.name, fn.name, fn) for cls in autograd_functions(tree)
            for fn in cls.body if isinstance(fn, ast.FunctionDef)
            and fn.name in ("forward", "backward")]


class _Module:
    """One parsed module plus the indexes every rule needs."""

    def __init__(self, tree: ast.Module, path: str):
        self.tree = tree
        self.path = path
        self.funcs = {n.name: n for n in tree.body
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))}
        # method name -> every same-module method of that name
        self.methods = {}
        for cls in (n for n in tree.body if isinstance(n, ast.ClassDef)):
            for fn in cls.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.methods.setdefault(fn.name, []).append(
                        (f"{cls.name}.{fn.name}", fn))
        self.numpy_aliases = set()
        for n in ast.walk(tree):
            if isinstance(n, ast.Import):
                for alias in n.names:
                    if alias.name == "numpy":
                        self.numpy_aliases.add(alias.asname or "numpy")

    def reachable(self):
        """``(name, FunctionDef)`` of every function reachable from the
        autograd bodies: module-level functions called by name, methods of
        same-module classes called by attribute; ``lru_cache`` stops the
        walk."""
        queue = [(f"{c}.{m}", fn) for c, m, fn in autograd_bodies(self.tree)]
        seen, out = set(), []
        while queue:
            name, fd = queue.pop()
            if id(fd) in seen:
                continue
            seen.add(id(fd))
            out.append((name, fd))
            for node in ast.walk(fd):
                if not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Name) and \
                        node.func.id in self.funcs:
                    target = self.funcs[node.func.id]
                    if not _is_lru(target):
                        queue.append((node.func.id, target))
                elif isinstance(node.func, ast.Attribute):
                    queue.extend((n, fn) for n, fn in
                                 self.methods.get(node.func.attr, ())
                                 if not _is_lru(fn))
        return out


# ------------------------------------------------------------------- rules
def _rule_traced_numpy(mod: _Module) -> list:
    findings = []
    for fname, fd in mod.reachable():
        for node in ast.walk(fd):
            if not isinstance(node, ast.Call):
                continue
            callee = _dotted(node.func) or ""
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in SYNC_METHODS:
                what = f".{node.func.attr}()"
            elif callee.split(".")[0] in mod.numpy_aliases:
                what = callee
            elif callee in SYNC_CALLS:
                what = callee
            else:
                continue
            findings.append(Finding(
                "traced-numpy", mod.path, node.lineno,
                f"host call `{what}` inside `{fname}`, which is reachable "
                "from an autograd Function's forward/backward; it leaves "
                "the tensor world or waits for the card on every product "
                "-- keep it out of the Function, or behind an lru_cache "
                "host-memoization boundary"))
    return findings


def _obs_import_map(tree: ast.Module) -> dict:
    """Local name -> fully dotted ``repro_torch.obs...`` origin, covering
    ``import repro_torch.obs.trace as t``, ``from repro_torch import obs``,
    ``from repro_torch.obs import trace as obs_trace`` and direct function
    imports (``from repro_torch.obs.trace import span``).  A bare ``import
    repro_torch.obs.trace`` binds ``repro_torch`` and is caught by the
    raw-prefix check in the rule instead."""
    out = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for alias in n.names:
                if alias.asname and (alias.name == _OBS
                                     or alias.name.startswith(_OBS + ".")):
                    out[alias.asname] = alias.name
        elif isinstance(n, ast.ImportFrom) and n.module and n.level == 0:
            for alias in n.names:
                full = f"{n.module}.{alias.name}"
                if full == _OBS or full.startswith(_OBS + "."):
                    out[alias.asname or alias.name] = full
    return out


def _rule_obs_host_only(mod: _Module) -> list:
    """R7: the R1 call graph, flagging ``repro_torch.obs`` calls; and no
    obs import in a kernel wrapper."""
    path = mod.path.replace(os.sep, "/")
    if "repro_torch/obs/" in path:
        return []
    obs_map = _obs_import_map(mod.tree)
    findings = []
    if os.path.basename(path) in KERNEL_WRAPPERS and "/kernels/" in path:
        for node in ast.walk(mod.tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            if any(m == _OBS or m.startswith(_OBS + ".") for m in mods) or \
                    (isinstance(node, ast.ImportFrom) and
                     node.module == "repro_torch" and
                     any(a.name == "obs" for a in node.names)):
                findings.append(Finding(
                    "obs-host-only", mod.path, node.lineno,
                    "a kernel wrapper imports an obs module; the wrappers "
                    "launch kernels and record nothing"))
    for fname, fd in mod.reachable():
        for node in ast.walk(fd):
            # a name bound to an obs module or function, or a call spelled
            # out from the package (``repro_torch.obs.trace.event(...)``)
            if isinstance(node, ast.Name) and node.id in obs_map:
                used = node.id
            elif isinstance(node, ast.Call) and \
                    ((_dotted(node.func) or "") + ".").startswith(_OBS + "."):
                used = _dotted(node.func)
            else:
                continue
            findings.append(Finding(
                "obs-host-only", mod.path, node.lineno,
                f"obs name `{used}` used inside `{fname}`, which is "
                "reachable from an autograd Function's forward/backward; "
                "observability is host-side -- record the event around "
                "the product, outside the Function"))
    return findings


def _rule_lru_static(mod: _Module) -> list:
    findings = []
    for fname, fd in mod.funcs.items():
        if not _is_lru(fd):
            continue
        defaults = list(fd.args.defaults) + \
            [d for d in fd.args.kw_defaults if d is not None]
        for d in defaults:
            if isinstance(d, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                              ast.DictComp, ast.SetComp)):
                findings.append(Finding(
                    "lru-cache-static", mod.path, d.lineno,
                    f"`{fname}` is lru_cache'd but has a mutable literal "
                    "default — unhashable, and shared across calls"))
        for arg in _all_args(fd):
            if arg.annotation is not None and \
                    _ann_unhashable(arg.annotation):
                findings.append(Finding(
                    "lru-cache-static", mod.path, arg.annotation.lineno,
                    f"`{fname}` is lru_cache'd but parameter "
                    f"`{arg.arg}` is annotated with an unhashable type; "
                    "cache keys must be hashable statics"))
    return findings


def _rule_autograd_pairing(mod: _Module) -> list:
    """R3 (``custom-vjp-pairing``) for ``torch.autograd.Function``s."""
    findings = []
    for cls in autograd_functions(mod.tree):
        fns = {fn.name: fn for fn in cls.body
               if isinstance(fn, ast.FunctionDef)}
        fwd, bwd = fns.get("forward"), fns.get("backward")
        if fwd is None or bwd is None:
            findings.append(Finding(
                "custom-vjp-pairing", mod.path, cls.lineno,
                f"autograd Function `{cls.name}` must define both forward "
                "and backward"))
            continue
        for fn in (fwd, bwd):
            if not any(_dec_name(d) == "staticmethod"
                       for d in fn.decorator_list):
                findings.append(Finding(
                    "custom-vjp-pairing", mod.path, fn.lineno,
                    f"`{cls.name}.{fn.name}` must be a staticmethod taking "
                    "ctx first"))
        n_in = _arity(fwd)
        n_out = {_literal_tuple_len(r.value) for r in _returns(fwd)}
        if len(n_out) == 1 and None not in n_out and \
                _arity(bwd) not in (None, 1 + min(n_out)):
            want = 1 + min(n_out)
            findings.append(Finding(
                "custom-vjp-pairing", mod.path, bwd.lineno,
                f"`{cls.name}.backward` takes {_arity(bwd)} args, want "
                f"{want} (ctx + one gradient per forward output)"))
        if n_in is None:
            continue
        for ret in _returns(bwd):
            got = _literal_tuple_len(ret.value)
            if got is not None and got != n_in - 1:
                findings.append(Finding(
                    "custom-vjp-pairing", mod.path, ret.lineno,
                    f"`{cls.name}.backward` returns {got} gradients, want "
                    f"{n_in - 1} (one per forward input after ctx)"))
    return findings


def _rule_static_aux(mod: _Module) -> list:
    findings = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        dc_dec = None
        for dec in node.decorator_list:
            if (_dec_name(dec) or "").endswith("dataclass"):
                dc_dec = dec
        if dc_dec is None or not _STATIC_AUX_RE.match(node.name):
            continue
        frozen = (isinstance(dc_dec, ast.Call)
                  and any(k.arg == "frozen"
                          and isinstance(k.value, ast.Constant)
                          and k.value.value is True
                          for k in dc_dec.keywords))
        if not frozen:
            findings.append(Finding(
                "static-aux-frozen", mod.path, node.lineno,
                f"dataclass `{node.name}` names a static-aux role "
                "(*Meta/*Spec/*Config/...) but is not frozen=True — it "
                "must be hashable to serve as a memo or cache key"))
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    _ann_unhashable(stmt.annotation):
                findings.append(Finding(
                    "static-aux-frozen", mod.path, stmt.lineno,
                    f"`{node.name}` field annotated with an unhashable "
                    "type; static-aux dataclasses must hash"))
    return findings


def check_fingerprint_fields(ops_src: str, autotune_src: str,
                             ops_path: str = "ops.py",
                             autotune_path: str = "autotune.py") -> list:
    """R5 (cross-file): every dispatch-relevant SparseMeta field is read
    by ``fingerprint``/``_make_fingerprint``, and every Fingerprint field
    (the port's ``device`` included) is rendered by ``key()``."""
    findings = []
    ops_tree = ast.parse(ops_src)
    at_tree = ast.parse(autotune_src)

    def _class(tree, name):
        for n in ast.walk(tree):
            if isinstance(n, ast.ClassDef) and n.name == name:
                return n
        return None

    def _fields(cls):
        return [(s.target.id, s.lineno) for s in cls.body
                if isinstance(s, ast.AnnAssign)
                and isinstance(s.target, ast.Name)]

    def _attr_reads(fn, base):
        return {n.attr for n in ast.walk(fn)
                if isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name) and n.value.id == base}

    sparse_meta = _class(ops_tree, "SparseMeta")
    fp_cls = _class(at_tree, "Fingerprint")
    if sparse_meta is None or fp_cls is None:
        return [Finding("fingerprint-fields", autotune_path, 0,
                        "could not locate SparseMeta/Fingerprint classes "
                        "to audit")]
    fp_fns = [n for n in ast.walk(at_tree)
              if isinstance(n, ast.FunctionDef)
              and n.name in ("fingerprint", "_make_fingerprint")]
    reads = set().union(*(_attr_reads(f, "meta") for f in fp_fns)) \
        if fp_fns else set()
    line = fp_fns[0].lineno if fp_fns else 0
    for fname, _ in _fields(sparse_meta):
        if fname not in FINGERPRINT_FIELD_ALLOWLIST and fname not in reads:
            findings.append(Finding(
                "fingerprint-fields", autotune_path, line,
                f"SparseMeta.{fname} is dispatch-relevant but never read "
                "by autotune.fingerprint — two metas differing only in it "
                "would alias one cache entry"))
    key_fn = next((n for n in fp_cls.body
                   if isinstance(n, ast.FunctionDef) and n.name == "key"),
                  None)
    if key_fn is None:
        findings.append(Finding("fingerprint-fields", autotune_path,
                                fp_cls.lineno,
                                "Fingerprint has no key() method"))
    else:
        key_reads = _attr_reads(key_fn, "self")
        for fname, fline in _fields(fp_cls):
            if fname not in key_reads:
                findings.append(Finding(
                    "fingerprint-fields", autotune_path, fline,
                    f"Fingerprint.{fname} is not rendered into key() — "
                    "distinct fingerprints would collide in the cache"))
    return findings


def check_package_facade(init_path: str,
                         package: str = "repro_torch") -> list:
    """R6: every name in the facade's ``__all__`` imports and resolves.

    The export list must be a LITERAL (``ast.literal_eval``-able) so the
    check cannot be fooled by a computed ``__all__``; resolution runs
    against the importable ``package`` on ``sys.path``."""
    with open(init_path) as f:
        tree = ast.parse(f.read())
    names = None
    line = 0
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "__all__":
                    line = node.lineno
                    try:
                        names = list(ast.literal_eval(node.value))
                    except ValueError:
                        return [Finding(
                            "package-facade", init_path, node.lineno,
                            "__all__ is not a literal list — the facade "
                            "check cannot verify computed exports")]
    if names is None:
        return [Finding("package-facade", init_path, 0,
                        "package facade has no __all__")]
    import importlib
    try:
        mod = importlib.import_module(package)
    except Exception as e:  # noqa: BLE001 — any import failure is the bug
        return [Finding("package-facade", init_path, line,
                        f"`import {package}` failed: {e!r}")]
    findings = []
    for name in names:
        try:
            getattr(mod, name)
        except Exception as e:  # noqa: BLE001
            findings.append(Finding(
                "package-facade", init_path, line,
                f"__all__ name {name!r} does not resolve on "
                f"`import {package}`: {e!r}"))
    return findings


# ------------------------------------------------------------- entrypoints
def lint_source(text: str, path: str = "<source>") -> list:
    """R1-R4 and R7 on one module's source text."""
    mod = _Module(ast.parse(text), path)
    return (_rule_traced_numpy(mod) + _rule_lru_static(mod)
            + _rule_autograd_pairing(mod) + _rule_static_aux(mod)
            + _rule_obs_host_only(mod))


def lint_file(path: str) -> list:
    with open(path) as f:
        return lint_source(f.read(), path)


def obs_host_only(src_root: str):
    """R7 alone over every ``.py`` under ``src_root``: ``(findings,
    bodies)``, ``bodies`` naming each autograd ``forward``/``backward``
    the rule started from (``path:Class.method``)."""
    findings, bodies = [], []
    for path in _py_files(src_root):
        with open(path) as f:
            mod = _Module(ast.parse(f.read()), path)
        findings += _rule_obs_host_only(mod)
        bodies += [f"{path}:{c}.{m}" for c, m, _ in autograd_bodies(mod.tree)]
    return findings, bodies


def _py_files(src_root: str):
    for dirpath, _, names in sorted(os.walk(src_root)):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def lint_tree(src_root: str) -> list:
    """All rules over every ``.py`` under ``src_root`` (R5 runs when the
    tree contains kernels/ops.py + kernels/autotune.py; R6 when it is the
    ``repro_torch`` package, with its ``__init__.py``)."""
    findings = []
    ops_path = autotune_path = None
    for path in _py_files(src_root):
        findings += lint_file(path)
        if path.endswith(os.path.join("kernels", "ops.py")):
            ops_path = path
        if path.endswith(os.path.join("kernels", "autotune.py")):
            autotune_path = path
    if ops_path and autotune_path:
        with open(ops_path) as f:
            ops_src = f.read()
        with open(autotune_path) as f:
            at_src = f.read()
        findings += check_fingerprint_fields(ops_src, at_src,
                                             ops_path, autotune_path)
    init_path = os.path.join(src_root, "__init__.py")
    if os.path.basename(os.path.normpath(src_root)) == "repro_torch" and \
            os.path.exists(init_path):      # fixture trees have no facade
        findings += check_package_facade(init_path)
    return findings
