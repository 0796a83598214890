"""The port's surface against the JAX package's, read from both packages'
sources with ``ast``: this file imports neither.

For each module of `mpcc_manipulator_tpu/` (one case a module):

(a) every public top-level name (a function, a class or a module constant
    with no leading underscore, and every entry of ``__all__``) has a
    counterpart of the same name in the port's module of the same path;
(b) every public member of each public JAX class (methods, properties,
    class attributes and fields, ``self.x`` attributes, each read through
    the bases the module defines) exists on the port's class;
(c) every parameter of each public JAX function and of each public method
    (``__init__`` included) is accepted by the port's counterpart;
(d) each JAX parameter a caller may pass by position sits at the same
    position in the port's counterpart (a class's constructor: its
    ``__init__``, or a dataclass's or NamedTuple's fields in order);
(e) each JAX default is the port's default, read as source text after
    :data:`TORCH_FOR_JNP` maps JAX's dtypes to PyTorch's (a port default
    where JAX has none is no finding: every JAX call passes that
    argument).

What has no counterpart is :data:`WITHOUT_COUNTERPART`, what keeps another
position :data:`OTHER_POSITION` and what keeps another default
:data:`OTHER_DEFAULT`, each entry with its reason; every entry must still
be needed.  (f) Every value of the string settings of JAX's `SQPConfig`
(:data:`JAX_SETTINGS`, and ``ipm_interpret``'s three) is accepted by the
port's ``check_supported``; the list fails when JAX's source compares a
setting against a value it lacks (this check imports the port, torch
only).  Two guards read the port: no file of it, and not `chip_smoke.py`,
imports JAX or the JAX package; no public function, class constructor or
CLI has a ``device`` that defaults to the CPU.
:func:`test_checker_reports_what_it_checks` runs the checker on small
sources that break each rule.

Alone: ``python -m pytest tests/test_torch_parity.py -q``.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "mpcc_manipulator_tpu")
PORT_PKG = os.path.join(ROOT, "mpcc_manipulator_tpu_torch")
FORBIDDEN_IMPORTS = ("jax", "jaxlib", "mpcc_manipulator_tpu")

_KERNEL_MODULE = ("a Pallas module: its kernel is CUDA C++ in csrc/ and its "
                  "wrapper the port's module named beside it, with other "
                  "names (build_qp_stages_k_kernel, kin_sweep, ...); each "
                  "wrapper takes JAX's interpret switch, which names the "
                  "plain version in the place of the Pallas interpreter "
                  "(ops/cuda_build.kernel_route)")
_JIT_HELPER = ("a jitted step of JAX's host-loop debug solver; the port's "
               "solve_ocp_timed runs solve_ocp with a timer (eager PyTorch "
               "has nothing to jit)")
_NATIVE_PATHS = ("JAX builds cpp/ in place; the port builds its own copy "
                 "of the source into build/native/ (BUILD_DIR, "
                 "library_path())")

#: JAX name -> (reason, the port's counterpart or None).  Keys: a module
#: ("ops/pallas_admm.py"), a name ("path::Name"), a member
#: ("path::Class.member") or a parameter ("path::function(param)").
WITHOUT_COUNTERPART = {
    "ops/pallas_admm.py": (_KERNEL_MODULE, "ops/admm_kernel.py"),
    "ops/pallas_assembly.py": (_KERNEL_MODULE, "ops/assembly_kernel.py"),
    "ops/pallas_kinematics.py": (_KERNEL_MODULE, "ops/kinematics_kernel.py"),
    "solver/qp_ipm_pallas.py": (_KERNEL_MODULE, "solver/qp_ipm_kernel.py"),
    "models/collision_nn.py::MLPParams": (
        "the weights are a torch.nn.Module", "models/collision_nn.py::"
        "CollisionMLP"),
    "models/collision_nn.py::mlp_forward(params)": (
        "the weights are a CollisionMLP, named net",
        "models/collision_nn.py::mlp_forward(net)"),
    "models/collision_nn.py::mlp_forward_jacobian(params)": (
        "the weights are a CollisionMLP, named net",
        "models/collision_nn.py::mlp_forward_jacobian(net)"),
    **{f"solver/sqp_debug.py::{name}": (_JIT_HELPER, None)
       for name in ("_build_qp_jit", "_eval_point_jit", "_denorm_jit",
                    "_build_stages_jit", "_soc_rep_jit", "_model_terms_jit")},
    "runtime/native.py::_CPP_DIR": (_NATIVE_PATHS, "runtime/native.py::"
                                    "BUILD_DIR"),
    "runtime/native.py::_LIB_PATH": (_NATIVE_PATHS, "runtime/native.py::"
                                     "library_path"),
}

_BENCH_DEFAULT = ("SQPConfig() is the bench configuration (RTI, the "
                  "structured IPM through K1 with a warm interior point, "
                  "K2/K3 assembly and evaluation, K4 kinematics with the "
                  "analytic gradient); JAX's default is "
                  "params.reference_sqp_config(), which api.MPCC runs")
_BATCH_FIRST = ("the port's carry is batch-first: init_carry(batch, dtype, "
                "device, system) makes B lanes where JAX's makes one, so "
                "every JAX parameter sits one place later")
_KEYWORD_IS_NERF = ("is_nerf is keyword-only and mm_dtype stays third, as "
                    "the port's callers pass it; a bool in mm_dtype raises, "
                    "so a JAX-style positional is_nerf fails loudly")

#: JAX parameter -> reason it sits at another position in the port (check
#: (d)).  Keys: "path::function(param)", "path::Class.method(param)",
#: "path::Class(param)" (a constructor).
OTHER_POSITION = {
    "mpc.py::init_carry(dtype)": _BATCH_FIRST,
    "mpc.py::init_carry(system)": _BATCH_FIRST,
    "models/collision_nn.py::mlp_forward_jacobian(is_nerf)": _KEYWORD_IS_NERF,
    "models/collision_nn.py::mlp_forward_jacobian(mm_dtype)": _KEYWORD_IS_NERF,
}

#: JAX parameter or field -> reason its default differs in the port (check
#: (e)); keys as for :data:`OTHER_POSITION`.
OTHER_DEFAULT = {
    f"params.py::SQPConfig({field})": _BENCH_DEFAULT
    for field in ("max_iter", "rti", "qp_solver", "ipm_warm_start",
                  "mani_grad", "qp_assembly", "kin_backend")}

#: JAX's dtype defaults and the port's for them, for check (e).
TORCH_FOR_JNP = {f"jnp.{t}": f"torch.{t}"
                 for t in ("float64", "float32", "bfloat16", "int32")}

#: every value JAX's SQPConfig routes take (the field comments of
#: `mpcc_manipulator_tpu/params.py` and the branches that read them), for
#: check (f)
JAX_SETTINGS = {
    "qp_solver": ("admm", "riccati", "riccati_struct", "riccati_pallas"),
    "qp_assembly": ("xla", "pallas"),
    "qp_backend": ("xla", "pallas", "pallas_interpret"),
    "ipm_scheme": ("adaptive", "mehrotra"),
    "line_search": ("filter", "merit"),
    "mani_grad": ("fd", "ad", "analytic"),
    "kin_backend": ("xla", "pallas"),
    "ipm_interpret": (None, True, False),
}
#: the names a setting's value travels under through JAX's source
SETTING_NAMES = {"qp_backend": ("qp_backend", "backend"),
                 "ipm_scheme": ("ipm_scheme", "scheme")}


# ------------------------------------------------------------------
# reading a module
# ------------------------------------------------------------------

def _names(target):
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            yield from _names(e)


def _public(name: str) -> bool:
    return not name.startswith("_")


class Module:
    """The top level of one module: its definitions (name -> node), the
    names it imports (name -> ``(module path, attribute or None)``, the
    path relative to its package when the import is relative) and its
    ``__all__``."""

    def __init__(self, source: str, rel: str = ""):
        self.rel = rel
        self.defs, self.imports, self.all = {}, {}, []
        for s in ast.parse(source).body:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                self.defs[s.name] = s
            elif isinstance(s, (ast.Assign, ast.AnnAssign)):
                targets = s.targets if isinstance(s, ast.Assign) else [s.target]
                for t in targets:
                    for n in _names(t):
                        self.defs[n] = s
                        if n == "__all__":
                            self.all = [e.value for e in s.value.elts]
            elif isinstance(s, ast.ImportFrom):
                for a in s.names:
                    self.imports[a.asname or a.name] = (
                        self._from(s.level, s.module), a.name)
            elif isinstance(s, ast.Import):
                for a in s.names:
                    self.imports[a.asname or a.name.split(".")[0]] = (
                        None, None)

    def _from(self, level: int, module: str | None):
        if not level:
            return None
        parts = [p for p in os.path.dirname(self.rel).split("/") if p]
        parts = parts[:max(len(parts) - (level - 1), 0)]
        return "/".join(parts + (module.split(".") if module else []))

    def has(self, name: str) -> bool:
        return name in self.defs or name in self.imports or name in self.all

    def public(self) -> list[str]:
        return sorted({n for n in self.defs if _public(n)} | set(self.all))

    def members(self, cls: ast.ClassDef) -> dict:
        """Member name -> node, the bases this module defines first."""
        out = {}
        for base in cls.bases:
            if (isinstance(base, ast.Name)
                    and isinstance(self.defs.get(base.id), ast.ClassDef)):
                out.update(self.members(self.defs[base.id]))
        for s in cls.body:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                out[s.name] = s
            elif isinstance(s, (ast.Assign, ast.AnnAssign)):
                targets = s.targets if isinstance(s, ast.Assign) else [s.target]
                for t in targets:
                    out.update((n, s) for n in _names(t))
        for s in cls.body:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for n in ast.walk(s):
                    targets = (n.targets if isinstance(n, ast.Assign) else
                               [n.target] if isinstance(n, ast.AnnAssign)
                               else [])
                    for t in targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            out.setdefault(t.attr, n)
        return out


def _params(fn) -> tuple[list[str], bool]:
    """(parameter names but self / cls, whether it takes ``**kwargs``)."""
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")], a.kwarg is not None


def _resolve(mod: Module, node, load):
    """``(module, node)`` a name stands for, ``f = module.g`` followed
    (``load(rel)`` reads another port module)."""
    if isinstance(node, ast.Assign) and load is not None:
        v = node.value
        if (isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name)
                and v.value.id in mod.imports):
            path, attr = mod.imports[v.value.id]
            other = (load("/".join(p for p in (path, f"{attr}.py") if p))
                     if path is not None else None)
            if other is not None and v.attr in other.defs:
                return _resolve(other, other.defs[v.attr], load)
    return mod, node


def _signature(mod: Module, node, load):
    """The parameters a port name accepts, ``(names, takes **kwargs)``, or
    None when they cannot be read.  A class gives its ``__init__``'s;
    ``f = module.g`` is followed."""
    mod, node = _resolve(mod, node, load)
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return _params(node)
    if isinstance(node, ast.ClassDef):
        init = mod.members(node).get("__init__")
        return _params(init) if isinstance(init, ast.FunctionDef) else None
    return None


def _arguments(fn) -> list:
    """``(name, positional, default node or None)`` of each parameter but
    self / cls, in order."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = [(p.arg, True, d) for p, d in zip(pos, defaults)]
    out += [(p.arg, False, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    return [o for o in out if o[0] not in ("self", "cls")]


def _is_record(cls: ast.ClassDef) -> bool:
    return (any("dataclass" in ast.unparse(d) for d in cls.decorator_list)
            or any(ast.unparse(b).endswith("NamedTuple") for b in cls.bases))


def _constructor(mod: Module, cls: ast.ClassDef):
    """A class's constructor arguments (as :func:`_arguments`): its
    ``__init__``'s, or a dataclass's or NamedTuple's fields in order (the
    bases this module defines first); None when neither."""
    init = mod.members(cls).get("__init__")
    if isinstance(init, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return _arguments(init)
    if not _is_record(cls):
        return None
    out = []
    for base in cls.bases:
        if (isinstance(base, ast.Name)
                and isinstance(mod.defs.get(base.id), ast.ClassDef)):
            out += _constructor(mod, mod.defs[base.id]) or []
    for s in cls.body:
        if (isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)
                and "ClassVar" not in ast.unparse(s.annotation)):
            out = [o for o in out if o[0] != s.target.id]
            out.append((s.target.id, True, s.value))
    return out


def _callables(jm: Module, pm: Module, load):
    """``(label, JAX arguments, port arguments)`` of each public JAX
    function, constructor and public method with a readable port
    counterpart."""
    for name in jm.public():
        if name not in pm.defs:
            continue
        jn = jm.defs.get(name)
        pmod, pn = _resolve(pm, pm.defs[name], load)
        if isinstance(jn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and isinstance(pn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield name, _arguments(jn), _arguments(pn)
        elif isinstance(jn, ast.ClassDef) and isinstance(pn, ast.ClassDef):
            jc, pc = _constructor(jm, jn), _constructor(pmod, pn)
            if jc is not None and pc is not None:
                yield name, jc, pc
            pmem = pmod.members(pn)
            for m, node in sorted(jm.members(jn).items()):
                other = pmem.get(m)
                if (_public(m) and isinstance(node, ast.FunctionDef)
                        and isinstance(other, ast.FunctionDef)):
                    yield f"{name}.{m}", _arguments(node), _arguments(other)


def _default_text(node) -> str:
    text = ast.unparse(node)
    text = TORCH_FOR_JNP.get(text, text)
    return re.sub(r"\bdataclasses\.field\(", "field(", text)


def diff_signatures(jax_src: str, port_src: str, rel: str = "", load=None,
                    renamed=None) -> tuple[list[str], list[str]]:
    """``(order, defaults)``: the JAX parameters a caller may pass by
    position that the port takes at another position or by keyword only
    (d), and the JAX defaults the port's counterpart does not share (e),
    each as ``label(param)``.  ``renamed`` maps ``(label, JAX param)`` to
    the port's name for it; a parameter the port lacks is (c)'s."""
    jm, pm = Module(jax_src, rel), Module(port_src, rel)
    renamed = renamed or {}
    order, defaults = [], []
    for label, jargs, pargs in _callables(jm, pm, load):
        ppos = [n for n, positional, _ in pargs if positional]
        pdef = {n: d for n, _, d in pargs}
        jpos = [n for n, positional, _ in jargs if positional]
        for name, positional, default in jargs:
            pname = renamed.get((label, name), name)
            if pname not in pdef:
                continue
            if positional and (pname not in ppos or ppos.index(pname)
                               != jpos.index(name)):
                order.append(f"{label}({name})")
            if default is not None and (
                    pdef[pname] is None
                    or _default_text(pdef[pname]) != _default_text(default)):
                defaults.append(f"{label}({name})")
    return sorted(order), sorted(defaults)


def _names_of(node) -> str | None:
    return (node.id if isinstance(node, ast.Name) else
            node.attr if isinstance(node, ast.Attribute) else None)


def setting_values(source: str, setting: str) -> set:
    """The strings ``source`` compares a setting against (``==``, ``!=``,
    ``in``, under any name of :data:`SETTING_NAMES`), and its annotated
    default there."""
    names = SETTING_NAMES.get(setting, (setting,))
    strings = lambda n: (
        [n.value] if isinstance(n, ast.Constant) and isinstance(n.value, str)
        else [e.value for e in n.elts if isinstance(e, ast.Constant)
              and isinstance(e.value, str)]
        if isinstance(n, (ast.Tuple, ast.List, ast.Set)) else [])
    found = set()
    for n in ast.walk(ast.parse(source)):
        if isinstance(n, ast.Compare):
            sides = [n.left] + n.comparators
            if any(_names_of(x) in names for x in sides):
                found.update(v for x in sides for v in strings(x))
        elif (isinstance(n, ast.AnnAssign) and _names_of(n.target) == setting
              and n.value is not None):
            found.update(strings(n.value))
    return found


def unaccepted(check, make, setting: str, values) -> list:
    """The ``values`` of ``setting`` for which ``check(make(setting=value))``
    raises ``ValueError`` or ``NotImplementedError``."""
    out = []
    for v in values:
        try:
            check(make(**{setting: v}))
        except (ValueError, NotImplementedError):
            out.append(v)
    return out


def diff_module(jax_src: str, port_src: str, rel: str = "",
                load=None) -> list[str]:
    """What the port's module lacks of the JAX module's surface: ``Name``,
    ``Class.member``, ``function(param)`` / ``Class.method(param)``, and
    ``name(?)`` where the port's parameters cannot be read.  ``load(rel)``
    reads another port module, for ``f = module.g``."""
    jm, pm = Module(jax_src, rel), Module(port_src, rel)
    out = []

    def params(jfn, pmod, pnode, label):
        want, _ = _params(jfn)
        got = _signature(pmod, pnode, load) if pnode is not None else None
        if got is None:
            out.append(f"{label}(?)")
        elif not got[1]:
            out.extend(f"{label}({p})" for p in want if p not in got[0])

    for name in jm.public():
        if not pm.has(name):
            out.append(name)
            continue
        jn, pn = jm.defs.get(name), pm.defs.get(name)
        if isinstance(jn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            params(jn, pm, pn, name)
        elif isinstance(jn, ast.ClassDef):
            if not isinstance(pn, ast.ClassDef):
                out.append(f"{name}(class)")
                continue
            jmem, pmem = jm.members(jn), pm.members(pn)
            for m, node in sorted(jmem.items()):
                if not (_public(m) or m == "__init__"):
                    continue
                if m == "__init__":
                    params(node, pm, pn, name)
                elif m not in pmem:
                    out.append(f"{name}.{m}")
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    params(node, pm, pmem[m], f"{name}.{m}")
    return out


def forbidden_imports(source: str) -> list[str]:
    """Every import of JAX or the JAX package in ``source``, anywhere in
    it: ``import x``, ``from x import y`` and ``importlib.import_module`` /
    ``__import__`` of a constant.  The port's own package
    (``mpcc_manipulator_tpu_torch``) is not the JAX package."""
    found = []
    for n in ast.walk(ast.parse(source)):
        if isinstance(n, ast.Import):
            mods = [a.name for a in n.names]
        elif isinstance(n, ast.ImportFrom) and not n.level:
            mods = [n.module]
        elif (isinstance(n, ast.Call) and n.args
              and isinstance(n.args[0], ast.Constant)
              and ast.unparse(n.func) in ("importlib.import_module",
                                          "import_module", "__import__")):
            mods = [str(n.args[0].value)]
        else:
            continue
        found += [m for m in mods if m.split(".")[0] in FORBIDDEN_IMPORTS]
    return found


def _is_cpu(node) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and ast.unparse(node.func)
            == "torch.device" and bool(node.args) and _is_cpu(node.args[0]))


def cpu_device_defaults(source: str) -> list[str]:
    """Public functions, public methods and constructors (``__init__``,
    dataclass fields) whose ``device`` parameter defaults to the CPU, and
    ``add_argument("--device", default="cpu")``."""
    mod = Module(source)
    found = []

    def check(fn, label):
        a = fn.args
        pos = a.posonlyargs + a.args
        pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
        pairs += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults) if d]
        found.extend(f"{label}({p.arg})" for p, d in pairs
                     if "device" in p.arg and _is_cpu(d))

    for name, node in mod.defs.items():
        if not _public(name):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            check(node, name)
        elif isinstance(node, ast.ClassDef):
            for m, s in mod.members(node).items():
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (_public(m) or m == "__init__"):
                    check(s, f"{name}.{m}")
                elif (isinstance(s, ast.AnnAssign) and "device" in m
                      and s.value is not None and _is_cpu(s.value)):
                    found.append(f"{name}.{m}")
    for n in ast.walk(ast.parse(source)):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "add_argument" and n.args
                and isinstance(n.args[0], ast.Constant)
                and "device" in str(n.args[0].value)):
            found += [f"--{n.args[0].value.lstrip('-')}" for k in n.keywords
                      if k.arg == "default" and _is_cpu(k.value)]
    return found


# ------------------------------------------------------------------
# the two packages
# ------------------------------------------------------------------

def _modules(pkg: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), pkg).replace(os.sep, "/")
                  for d, _, files in os.walk(pkg) for f in files
                  if f.endswith(".py"))


def _read(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def _load_port(rel: str) -> Module | None:
    path = os.path.join(PORT_PKG, rel)
    return Module(_read(path), rel) if os.path.exists(path) else None


def _findings(rel: str) -> list[str]:
    """The JAX module's names the port lacks, as table keys."""
    port = os.path.join(PORT_PKG, rel)
    if not os.path.exists(port):
        return [rel]
    return [f"{rel}::{f}" for f in diff_module(
        _read(os.path.join(JAX_PKG, rel)), _read(port), rel, _load_port)]


JAX_MODULES = _modules(JAX_PKG)
PORT_FILES = ([os.path.join("mpcc_manipulator_tpu_torch", m)
               for m in _modules(PORT_PKG)] + ["chip_smoke.py"])


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_has_its_counterpart(rel):
    missing = [f for f in _findings(rel) if f not in WITHOUT_COUNTERPART]
    assert not missing, (
        f"the port lacks these of the JAX package's {rel}; port them, or "
        f"give each a reason in WITHOUT_COUNTERPART: {missing}")


def _jax_has(key: str) -> bool:
    rel, _, rest = key.partition("::")
    path = os.path.join(JAX_PKG, rel)
    if not rest:
        return os.path.exists(path)
    mod = Module(_read(path), rel)
    name, _, param = rest.partition("(")
    name, _, member = name.partition(".")
    node = mod.defs.get(name)
    if node is None:
        return False
    if member:
        node = mod.members(node).get(member) if isinstance(
            node, ast.ClassDef) else None
    if param:
        return (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and param.rstrip(")") in _params(node)[0])
    return node is not None


def _port_has(key: str) -> bool:
    rel, _, rest = key.partition("::")
    mod = _load_port(rel)
    if mod is None or not rest:
        return mod is not None
    name, _, param = rest.partition("(")
    if not mod.has(name):
        return False
    return not param or param.rstrip(")") in _signature(
        mod, mod.defs[name], _load_port)[0]


@pytest.mark.parametrize("key", sorted(WITHOUT_COUNTERPART))
def test_without_counterpart_entry_is_live(key):
    """Each entry names something of the JAX package, has a reason, and
    names an existing port counterpart where it gives one; a public entry
    is one the checker reports without it."""
    reason, port = WITHOUT_COUNTERPART[key]
    assert reason and _jax_has(key), key
    assert port is None or _port_has(port), (key, port)
    rel, _, rest = key.partition("::")
    if _public(rest.split(".")[-1]):
        assert key in _findings(rel), (
            f"{key}: the port has it now; drop the entry")


def _renamed(rel: str) -> dict:
    """``(label, JAX param) -> port param`` from the parameter entries of
    :data:`WITHOUT_COUNTERPART` whose counterpart is a parameter of the
    same function."""
    out = {}
    for key, (_, port) in WITHOUT_COUNTERPART.items():
        if port and key.startswith(f"{rel}::") and "(" in key:
            label, _, param = key.split("::")[1].partition("(")
            plabel, _, pparam = port.split("::")[-1].partition("(")
            if plabel == label and pparam:
                out[(label, param.rstrip(")"))] = pparam.rstrip(")")
    return out


def _signature_findings(rel: str) -> tuple[list[str], list[str]]:
    """(d) and (e) of one module, as table keys."""
    port = os.path.join(PORT_PKG, rel)
    if not os.path.exists(port):
        return [], []
    order, defaults = diff_signatures(
        _read(os.path.join(JAX_PKG, rel)), _read(port), rel, _load_port,
        _renamed(rel))
    return ([f"{rel}::{f}" for f in order],
            [f"{rel}::{f}" for f in defaults])


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_keeps_jax_positions(rel):
    moved = [f for f in _signature_findings(rel)[0]
             if f not in OTHER_POSITION]
    assert not moved, (
        f"the port takes these parameters of the JAX package's {rel} at "
        f"another position (a JAX-style positional call binds them to "
        f"others); move them, or give each a reason in OTHER_POSITION: "
        f"{moved}")


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_keeps_jax_defaults(rel):
    changed = [f for f in _signature_findings(rel)[1]
               if f not in OTHER_DEFAULT]
    assert not changed, (
        f"the port's defaults differ from the JAX package's {rel} here; "
        f"take JAX's, or give each a reason in OTHER_DEFAULT: {changed}")


@pytest.mark.parametrize("table,key", [
    *(("position", k) for k in sorted(OTHER_POSITION)),
    *(("default", k) for k in sorted(OTHER_DEFAULT))])
def test_signature_entry_is_live(table, key):
    """Each entry has a reason and is one the checker reports."""
    reasons = OTHER_POSITION if table == "position" else OTHER_DEFAULT
    assert reasons[key], key
    order, defaults = _signature_findings(key.partition("::")[0])
    assert key in (order if table == "position" else defaults), (
        f"{key}: the port takes JAX's {table} now; drop the entry")


JAX_FILES = [os.path.join(JAX_PKG, m) for m in JAX_MODULES]


@pytest.mark.parametrize("setting", sorted(JAX_SETTINGS))
def test_jax_names_no_setting_value_beyond_the_list(setting):
    """(f), the list's side: every string JAX's source compares the
    setting against is in :data:`JAX_SETTINGS`."""
    found = set().union(*(setting_values(_read(f), setting)
                          for f in JAX_FILES))
    assert found <= set(JAX_SETTINGS[setting]), (
        f"JAX's source names {sorted(found - set(JAX_SETTINGS[setting]))} "
        f"for {setting}: add them to JAX_SETTINGS")


@pytest.mark.parametrize("setting", sorted(JAX_SETTINGS))
def test_port_accepts_every_jax_setting_value(setting):
    """(f), the port's side: ``check_supported`` takes every value of
    :data:`JAX_SETTINGS` (on the plain assembly and kinematics, which
    every solver route takes; the kernel assembly with the default
    solver)."""
    from mpcc_manipulator_tpu_torch.params import SQPConfig
    from mpcc_manipulator_tpu_torch.solver.sqp import check_supported
    base = SQPConfig(qp_assembly="xla", kin_backend="xla")
    assert not unaccepted(check_supported,
                          lambda **kw: dataclasses.replace(base, **kw),
                          setting, JAX_SETTINGS[setting])


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_imports_no_jax(rel):
    assert not forbidden_imports(_read(os.path.join(ROOT, rel))), rel


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_defaults_to_the_card(rel):
    assert not cpu_device_defaults(_read(os.path.join(ROOT, rel))), rel


JAX_SRC = '''
import jax
LIMIT = 3
__all__ = ["solve", "Model", "LIMIT", "lazy"]

def solve(qp, max_iter=10, interpret=False):
    return qp

def _private(x):
    return x

class _Base:
    def reset(self, seed):
        self.seed = seed

class Model(_Base):
    width: int = 4
    def __init__(self, path, dtype=None):
        self.path = path
    def run(self, x, verbose=False):
        return x
'''

PORT_SRC = '''
import torch
from mpcc_manipulator_tpu_torch import params
from .models import kinematics as kin
__all__ = ["solve", "Model"]

def solve(qp, max_iter=10):
    import jax.numpy as jnp
    return qp

class Model:
    width: int = 4
    def __init__(self, path, dtype=None, device="cpu"):
        self.path = path
    def run(self, x):
        return x
'''


SIG_JAX = '''
import dataclasses
def step(x, dtype=jnp.float64, system=PANDA, scale=2):
    pass

class Model:
    def __init__(self, path, dtype=None):
        self.path = path
    def run(self, x, verbose=False):
        return x

@dataclasses.dataclass
class Config:
    rti: bool = False
    mode: str = "admm"
'''

SIG_PORT = '''
import dataclasses
def step(x, dtype=torch.float64, device="cuda", system=PANDA, *, scale=3):
    pass

class Model:
    def __init__(self, path, device="cuda", dtype=None):
        self.path = path
    def run(self, verbose=False, x=None):
        return x

@dataclasses.dataclass
class Config:
    rti: bool = True
    mode: str = "admm"
'''

SETTING_SRC = '''
def route(cfg, backend):
    if cfg.qp_backend == "pallas_gpu" or backend in ("xla", "pallas"):
        return cfg.qp_solver != "admm"

class SQPConfig:
    qp_backend: str = "xla"
'''


def test_checker_reports_what_it_checks():
    assert diff_module(JAX_SRC, PORT_SRC) == [
        "LIMIT", "Model.reset", "Model.run(verbose)", "Model.seed", "lazy",
        "solve(interpret)"]
    assert diff_module(JAX_SRC, JAX_SRC) == []
    assert forbidden_imports(PORT_SRC) == ["jax.numpy"]
    assert forbidden_imports(JAX_SRC) == ["jax"]
    assert forbidden_imports(
        "import mpcc_manipulator_tpu.ocp as o\nimport mpcc_manipulator_tpu_torch"
        "\nimport importlib\nimportlib.import_module('jaxlib')") == [
            "mpcc_manipulator_tpu.ocp", "jaxlib"]
    assert cpu_device_defaults(PORT_SRC) == ["Model.__init__(device)"]
    assert cpu_device_defaults(
        "def f(x, *, device=torch.device('cpu')): pass\n"
        "def _g(device='cpu'): pass\n"
        "ap.add_argument('--device', default='cpu')") == [
            "f(device)", "--device"]
    # (d) and (e): positions and defaults; jnp dtypes read as torch's
    assert diff_signatures(SIG_JAX, SIG_PORT) == (
        ["Model(dtype)", "Model.run(verbose)", "Model.run(x)",
         "step(scale)", "step(system)"],
        ["Config(rti)", "step(scale)"])
    assert diff_signatures(SIG_JAX, SIG_JAX) == ([], [])
    # (f): a value JAX's source names beyond the list, and a value the
    # port's check refuses
    assert setting_values(SETTING_SRC, "qp_backend") == {
        "pallas_gpu", "xla", "pallas"}
    assert setting_values(SETTING_SRC, "qp_solver") == {"admm"}
    assert not setting_values(SETTING_SRC, "qp_backend") <= set(
        JAX_SETTINGS["qp_backend"])

    def refuses_interpret(cfg):
        if cfg["ipm_interpret"] is not None:
            raise NotImplementedError("ipm_interpret")

    assert unaccepted(refuses_interpret, dict, "ipm_interpret",
                      JAX_SETTINGS["ipm_interpret"]) == [True, False]
