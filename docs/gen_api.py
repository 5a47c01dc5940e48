"""Generate markdown API docs for openfdcm_tpu into ``docs/api/``.

Self-contained analogue of the reference's Doxygen target
(``/root/reference/docs/CMakeLists.txt:1-24``): walks the public modules
with ``inspect`` and emits one markdown page per module plus an index.
Run: ``python docs/gen_api.py`` (CI runs it to keep docs fresh).
"""
import importlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "docs", "api")

# Doc generation never needs an accelerator; keep it on the CPU.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

MODULES = [
    "openfdcm_tpu",
    "openfdcm_tpu.core.geometry",
    "openfdcm_tpu.core.rasterize",
    "openfdcm_tpu.core.draw",
    "openfdcm_tpu.core.dt",
    "openfdcm_tpu.core.integral",
    "openfdcm_tpu.core.io",
    "openfdcm_tpu.core.utils",
    "openfdcm_tpu.core.types",
    "openfdcm_tpu.matching.featuremap",
    "openfdcm_tpu.matching.search",
    "openfdcm_tpu.matching.optimize",
    "openfdcm_tpu.matching.match",
    "openfdcm_tpu.matching.penalty",
    "openfdcm_tpu.matching.pipeline",
    "openfdcm_tpu.parallel",
    "openfdcm_tpu.parallel.sharded",
    "openfdcm_tpu.parallel.spatial",
    "openfdcm_tpu.parallel.bank",
    "openfdcm_tpu.parallel.distributed",
    "openfdcm_tpu.pose",
    "openfdcm_tpu.sweep",
    "openfdcm_tpu.serving",
    "openfdcm_tpu.viz",
    "openfdcm_tpu.profiling",
    "openfdcm_tpu.compat",
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d if d else "*(undocumented)*"


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, o in vars(mod).items()
                 if not n.startswith("_")
                 and getattr(o, "__module__", None) == mod.__name__]
    out = []
    for n in names:
        o = getattr(mod, n, None)
        if o is not None and (inspect.isfunction(o) or inspect.isclass(o)
                              or callable(o)):
            out.append((n, o))
    return out


def render_module(name: str) -> str:
    mod = importlib.import_module(name)
    lines = [f"# `{name}`", ""]
    if mod.__doc__:
        lines += [inspect.cleandoc(mod.__doc__), ""]
    for n, o in _public_members(mod):
        if inspect.isclass(o):
            lines += [f"## class `{n}{_sig(o)}`", "", _doc(o), ""]
            for mn, mo in inspect.getmembers(o):
                if mn.startswith("_") or not (inspect.isfunction(mo)
                                              or isinstance(mo, property)):
                    continue
                if isinstance(mo, property):
                    lines += [f"### property `{mn}`", "", _doc(mo), ""]
                elif mo.__qualname__.startswith(o.__name__ + "."):
                    lines += [f"### `{mn}{_sig(mo)}`", "", _doc(mo), ""]
        else:
            lines += [f"## `{n}{_sig(o)}`", "", _doc(o), ""]
    return "\n".join(lines)


def main():
    os.makedirs(OUT, exist_ok=True)
    index = ["# openfdcm_tpu API reference", "",
             "Generated by `python docs/gen_api.py`.", ""]
    for name in MODULES:
        page = name.replace(".", "_") + ".md"
        with open(os.path.join(OUT, page), "w") as f:
            f.write(render_module(name))
        mod = importlib.import_module(name)
        hook = (inspect.cleandoc(mod.__doc__).splitlines()[0]
                if mod.__doc__ else "")
        index.append(f"- [`{name}`]({page}) — {hook}")
    with open(os.path.join(OUT, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print(f"wrote {len(MODULES) + 1} pages to {OUT}")


if __name__ == "__main__":
    main()
