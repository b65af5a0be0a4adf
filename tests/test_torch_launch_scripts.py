"""The port's launch scripts (``experiments/hateful_discussions/
run_train.sh``, ``sample_run.sh``) against the JAX package's: each script
runs with a stub ``python`` first on ``PATH`` that prints its argv, and the
port's argv must equal JAX's but for the module name and ``--hf-init``
(passed by the port's copy only with ``HF_INIT=1``). Positional arguments,
``SAVE_DIR``, ``RESTORE_FILE`` (-> ``--restore-file X --reset-optimizer``)
and the arguments after the sixth are covered."""

import os
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, "multimodaldiscussiontransformer_tpu", "experiments", "hateful_discussions")
PORT_DIR = os.path.join(ROOT, "multimodaldiscussiontransformer_tpu_torch", "experiments", "hateful_discussions")


def _argv(script, args, env_extra, bindir):
    env = {**os.environ, "PATH": f"{bindir}{os.pathsep}{os.environ['PATH']}", **env_extra}
    for key in ("SAVE_DIR", "RESTORE_FILE", "HF_INIT"):
        if key not in env_extra:
            env.pop(key, None)
    proc = subprocess.run(["bash", script, *args], env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.rstrip("\n").split("\n")


@pytest.fixture
def stub(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "python").write_text('#!/bin/sh\nfor a in "$@"; do printf "%s\\n" "$a"; done\n')
    (bindir / "python").chmod(0o755)
    return bindir


def _port_view(argv):
    """JAX's argv as the port's copy gives it: the port's module, no --hf-init."""
    return [a.replace("multimodaldiscussiontransformer_tpu.", "multimodaldiscussiontransformer_tpu_torch.")
            for a in argv if a != "--hf-init"]


CASES = [
    ("run_train.sh", ["8", "4", "5", "2", "2", "0"], {}),
    ("run_train.sh", ["4", "2", "3", "1", "1", "2", "--max-updates", "2", "--data-root", "D"],
     {"SAVE_DIR": "S", "RESTORE_FILE": "R"}),
    ("run_train.sh", [], {}),
    ("sample_run.sh", [], {}),
    ("sample_run.sh", [], {"RESTORE_FILE": "ckpt/stage1", "SAVE_DIR": "out"}),
]


@pytest.mark.parametrize("script,args,env", CASES)
def test_port_script_argv_equals_jax(stub, script, args, env):
    want = _argv(os.path.join(JAX_DIR, script), args, env, stub)
    got = _argv(os.path.join(PORT_DIR, script), args, env, stub)
    assert "--hf-init" in want and "--hf-init" not in got
    assert got == _port_view(want)
    assert got[:2] == ["-m", "multimodaldiscussiontransformer_tpu_torch.train.launch"]
    if env.get("RESTORE_FILE"):
        i = got.index("--restore-file")
        assert got[i + 1:i + 3] == [env["RESTORE_FILE"], "--reset-optimizer"]


def test_hf_init_is_passed_only_when_asked(stub):
    want = _argv(os.path.join(JAX_DIR, "sample_run.sh"), [], {}, stub)
    got = _argv(os.path.join(PORT_DIR, "sample_run.sh"), [], {"HF_INIT": "1"}, stub)
    assert got == [a.replace("multimodaldiscussiontransformer_tpu.", "multimodaldiscussiontransformer_tpu_torch.")
                   for a in want]


def test_sample_run_passes_arguments_on(stub):
    base = _argv(os.path.join(PORT_DIR, "sample_run.sh"), [], {}, stub)
    got = _argv(os.path.join(PORT_DIR, "sample_run.sh"), ["--data-root", "D", "--max-updates", "2"], {}, stub)
    assert got == base + ["--data-root", "D", "--max-updates", "2"]
