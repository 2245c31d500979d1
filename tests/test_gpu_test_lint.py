"""Static undefined-name lint for card-only test files.

tests/test_bitsliced_gpu.py skips every test without a GPU, so the CPU
suite never executes its test bodies — a name dropped from its imports
would only show as a NameError on the card. This check parses the gated
file and verifies every name
*loaded* in a function body is bound somewhere: function-locally, at
module level (imports/defs/assignments), or as a builtin. Conservative
on scoping (anything stored anywhere in the function counts as bound),
so it cannot false-alarm; it exists to catch exactly the
unbound-anywhere case.
"""
import ast
import builtins
from pathlib import Path

TESTS_DIR = Path(__file__).resolve().parent
GATED_FILES = ["test_bitsliced_gpu.py"]


def _module_level_names(tree: ast.Module) -> set:
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            names.update(a.asname or a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            for t in ast.walk(node):
                if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store):
                    names.add(t.id)
        elif isinstance(node, (ast.If, ast.Try, ast.With, ast.For,
                               ast.While)):
            # names bound inside module-level control flow (e.g. gated
            # imports) still land in module scope
            for t in ast.walk(node):
                if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store):
                    names.add(t.id)
                elif isinstance(t, (ast.Import, ast.ImportFrom)):
                    names.update(a.asname or (a.name or "*").split(".")[0]
                                 for a in t.names)
                elif isinstance(t, ast.ExceptHandler) and t.name:
                    names.add(t.name)
    return names


#: local modules whose from-imports the lint additionally resolves by
#: importing them on CPU: a stale `from conftest import X` binds X
#: statically (so the undefined-name walk passes) yet still raises
#: ImportError at collection time on the card — the sibling of the bug
#: this lint exists for
_LOCAL_MODULE_PREFIXES = ("conftest", "libflagstats_tpu")


def _stale_local_from_imports(tree: ast.Module, fname: str) -> list:
    import importlib

    problems = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or node.level or not node.module:
            continue
        root = node.module.split(".")[0]
        if root not in _LOCAL_MODULE_PREFIXES:
            continue
        mod = importlib.import_module(node.module)
        for alias in node.names:
            if alias.name != "*" and not hasattr(mod, alias.name):
                problems.append(f"{fname}: from {node.module} import "
                                f"{alias.name}: attribute does not exist")
    return problems


def _function_loads_unbound(fn: ast.FunctionDef, module_names: set) -> set:
    bound = {a.arg for a in (fn.args.args + fn.args.posonlyargs
                             + fn.args.kwonlyargs)}
    if fn.args.vararg:
        bound.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        bound.add(fn.args.kwarg.arg)
    loads = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Store):
                bound.add(node.id)
            elif isinstance(node.ctx, ast.Load):
                loads.add(node.id)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            # `except E as e:` binds e via a plain str attribute, not an
            # ast.Name Store
            bound.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound.update(a.asname or (a.name or "*").split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
            if node is not fn:
                # nested callables get their name and params counted as
                # bound — conservative, keeps the checker false-positive-free
                if not isinstance(node, ast.Lambda):
                    bound.add(node.name)
                a = node.args
                bound.update(x.arg for x in (a.args + a.posonlyargs
                                             + a.kwonlyargs))
                if a.vararg:
                    bound.add(a.vararg.arg)
                if a.kwarg:
                    bound.add(a.kwarg.arg)
    return {n for n in loads
            if n not in bound
            and n not in module_names
            and not hasattr(builtins, n)}


def _test_functions(tree: ast.Module):
    """Module-level and class-level (async) functions — the scopes where
    module_names is the correct enclosing namespace."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
        elif isinstance(node, ast.ClassDef):
            stack.extend(node.body)


def test_gpu_gated_files_have_no_unbound_names():
    problems = []
    for fname in GATED_FILES:
        path = TESTS_DIR / fname
        tree = ast.parse(path.read_text(), filename=str(path))
        module_names = _module_level_names(tree)
        # lint tests inside classes and async tests too — but do NOT
        # descend into nested defs (their closures legitimately load
        # enclosing-function names and would false-positive)
        for node in _test_functions(tree):
            missing = _function_loads_unbound(node, module_names)
            for name in sorted(missing):
                problems.append(f"{fname}:{node.name}: "
                                f"unbound name {name!r}")
        problems.extend(_stale_local_from_imports(tree, fname))
    assert not problems, "\n".join(problems)


def test_lint_catches_a_seeded_unbound_name():
    """The checker must actually flag the failure mode it exists for
    (a name used in a test body but missing from the imports)."""
    src = ("import os\n"
           "def test_x():\n"
           "    ref = pospopcnt_ref(os.getpid())\n")
    tree = ast.parse(src)
    module_names = _module_level_names(tree)
    fn = tree.body[1]
    assert _function_loads_unbound(fn, module_names) == {"pospopcnt_ref"}


def test_lint_covers_class_and_async_tests():
    """Tests inside classes and async tests are linted (advisor round 2),
    while nested closures loading enclosing names are not flagged."""
    src = ("class TestGroup:\n"
           "    def test_a(self):\n"
           "        return missing_in_class()\n"
           "async def test_b():\n"
           "    return missing_async()\n"
           "def test_c():\n"
           "    n = 3\n"
           "    def body(a):\n"
           "        return a + n\n"   # closure load of n: not a problem
           "    return body(1)\n")
    tree = ast.parse(src)
    module_names = _module_level_names(tree)
    found = {}
    for fn in _test_functions(tree):
        found[fn.name] = _function_loads_unbound(fn, module_names)
    assert found["test_a"] == {"missing_in_class"}
    assert found["test_b"] == {"missing_async"}
    assert found["test_c"] == set()


def test_lint_except_handler_name_is_bound():
    """`except E as e:` binds e (str attribute, not an ast.Name Store) —
    using e in the handler must not false-positive."""
    src = ("def test_x():\n"
           "    try:\n"
           "        pass\n"
           "    except ValueError as e:\n"
           "        return str(e)\n")
    tree = ast.parse(src)
    fn = tree.body[0]
    assert _function_loads_unbound(fn, _module_level_names(tree)) == set()


def test_lint_resolves_local_from_imports():
    """A stale `from libflagstats_tpu import X` binds X statically but
    still dies at collection time on the card — the resolver must flag it, and
    must accept a real attribute."""
    good = ast.parse("from libflagstats_tpu import flagstats\n")
    assert _stale_local_from_imports(good, "f.py") == []
    bad = ast.parse("from libflagstats_tpu import not_a_real_name\n")
    assert _stale_local_from_imports(bad, "f.py") == [
        "f.py: from libflagstats_tpu import not_a_real_name: "
        "attribute does not exist"
    ]
