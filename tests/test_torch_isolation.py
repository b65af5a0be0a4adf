"""The port imports neither JAX nor anything of the JAX package.

A fresh interpreter blocks ``jax``, ``flax``, ``optax``, ``orbax`` and the
JAX package with a meta-path finder, imports the port and every one of its submodules
(and ``chip_smoke.py``), and then checks ``sys.modules``. Names are compared
exactly or by ``name + "."``: the port's own name begins with the JAX
package's.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "multimodaldiscussiontransformer_tpu")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import multimodaldiscussiontransformer_tpu_torch as port
    names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401
    leaked = sorted(n for n in sys.modules if blocked(n))
    print("IMPORTED", len(names))
    print("NAMES", " ".join(names))
    print("LEAKED", leaked)
    """
)


def test_port_imports_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    lines = dict(ln.split(" ", 1) for ln in proc.stdout.splitlines() if ln.startswith(("IMPORTED", "LEAKED", "NAMES")))
    assert int(lines["IMPORTED"]) >= 15, proc.stdout
    for module in ("experiments.hateful_discussions.dataset", "experiments.hateful_discussions.ingest",
                   "experiments.hateful_discussions.two_stage", "experiments.hateful_discussions.context_ablation",
                   "experiments.hateful_discussions.readiness", "experiments.comment_only",
                   "experiments.comment_only.text_bert", "experiments.comment_only.trainval",
                   "utils.checkpoints", "utils.average_checkpoints"):
        assert f"multimodaldiscussiontransformer_tpu_torch.{module}" in lines["NAMES"].split(), module
    assert lines["LEAKED"] == "[]", proc.stdout
