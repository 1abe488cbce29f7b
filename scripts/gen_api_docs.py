#!/usr/bin/env python
"""Generate the markdown API reference under docs/api/.

The reference ships Doxygen-generated API docs (/root/reference/Doxyfile,
docs/html); this is the framework's equivalent: one markdown page per
module, built from live signatures + docstrings so it cannot drift from the
code.  Regenerate with:

    python scripts/gen_api_docs.py

CI guards freshness via tests/test_api_docs.py.
"""

import importlib
import inspect
import os
import pkgutil
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

PACKAGE = "navierstokes_parallel_tpu"
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "docs", "api")


def _signature(obj):
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # Function-object defaults repr as "<function f at 0x7f...>" — strip the
    # address so regeneration is deterministic across processes.  Drop the
    # " at 0x..." token itself rather than re-composing around the name:
    # names like "<lambda>" contain angle brackets that defeat a
    # name-matching pattern.
    return re.sub(r" at 0x[0-9a-fA-F]+", "", sig)


def _doc(obj):
    return inspect.getdoc(obj) or ""


def _is_local(obj, module):
    return getattr(obj, "__module__", None) == module.__name__


def _document_class(cls, lines):
    lines.append(f"### class `{cls.__name__}{_signature(cls)}`\n")
    doc = _doc(cls)
    if doc:
        lines.append(doc + "\n")
    for name, member in sorted(vars(cls).items()):
        if name.startswith("_"):
            continue
        if callable(member):
            lines.append(f"#### `{cls.__name__}.{name}{_signature(member)}`\n")
            d = _doc(member)
            if d:
                lines.append(d + "\n")
        elif isinstance(member, property):
            lines.append(f"#### property `{cls.__name__}.{name}`\n")
            d = _doc(member)
            if d:
                lines.append(d + "\n")


def document_module(modname: str) -> str:
    module = importlib.import_module(modname)
    lines = [f"# `{modname}`\n"]
    doc = _doc(module)
    if doc:
        lines.append(doc + "\n")

    classes = []
    functions = []
    for name, obj in sorted(vars(module).items()):
        if name.startswith("_"):
            continue
        if inspect.isclass(obj) and _is_local(obj, module):
            classes.append(obj)
        elif inspect.isfunction(obj) and _is_local(obj, module):
            functions.append(obj)

    for cls in classes:
        _document_class(cls, lines)
    for fn in functions:
        lines.append(f"### `{fn.__name__}{_signature(fn)}`\n")
        d = _doc(fn)
        if d:
            lines.append(d + "\n")
    return "\n".join(lines) + "\n"


def iter_modules():
    pkg = importlib.import_module(PACKAGE)
    yield PACKAGE
    for info in pkgutil.walk_packages(pkg.__path__, prefix=PACKAGE + "."):
        if info.name.endswith("__main__"):
            continue
        yield info.name


def main() -> int:
    os.makedirs(OUT_DIR, exist_ok=True)
    index = ["# API reference\n",
             "Generated by `python scripts/gen_api_docs.py` — do not edit "
             "by hand.\n"]
    for modname in sorted(set(iter_modules())):
        try:
            text = document_module(modname)
        except Exception as e:  # pragma: no cover
            print(f"skip {modname}: {e}", file=sys.stderr)
            continue
        fname = modname.replace(".", "_") + ".md"
        with open(os.path.join(OUT_DIR, fname), "w") as fh:
            fh.write(text)
        index.append(f"- [`{modname}`]({fname})")
    with open(os.path.join(OUT_DIR, "index.md"), "w") as fh:
        fh.write("\n".join(index) + "\n")
    print(f"wrote {OUT_DIR}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
