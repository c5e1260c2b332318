"""The port to an NVIDIA GPU: the compile cache location, the contract of
`chip_smoke.py` off a card, the imports of the main path, and the matmul
precision of the parity paths."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import acoss_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT, env_extra=None, drop=(), timeout=300):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


# ------------------------------------------------------- compile cache

def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = acoss_jax.compile_cache_dir()
    assert path == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert acoss_jax.compile_cache_dir() is None


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_config_after_import(tmp_path, env):
    """What a fresh process ends up with after `import acoss_jax`."""
    want = str(tmp_path / "cc") if env else os.path.join(ROOT, ".jax_cache")
    r = _run(["-c", "import acoss_jax, jax; "
                    "print(jax.config.jax_compilation_cache_dir)"],
             env_extra={"JAX_COMPILATION_CACHE_DIR": want} if env else None,
             drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == want


# ---------------------------------------------------------- chip_smoke

def test_chip_smoke_fails_without_a_gpu():
    r = _run(["chip_smoke.py"], env_extra={"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stdout + r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path, drop=("PYTHONPATH",))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


class _Dev:
    platform, device_kind = "gpu", "fake card"


@pytest.fixture
def smoke(monkeypatch):
    """chip_smoke with a fake card and every phase replaced by a stub
    that records its letter (and raises if its letter is in `fail`)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    from acoss_jax.benchmarking.algorithms import Serra09

    calls, fail = [], set()

    def stub(*a, _l):
        calls.append(_l)
        if _l in fail:
            raise RuntimeError(f"phase {_l} broke")

    monkeypatch.setattr(chip_smoke, "phase_device",
                        lambda n: [_Dev()] * (4 if n == 4 else 1))
    monkeypatch.setattr(chip_smoke, "covers80_corpus",
                        lambda seed: (type("FS", (), {"n_songs": 2}), None))
    monkeypatch.setattr(Serra09, "extract_descriptors", lambda self, fs: {})
    for letter, name in zip("bcdef", ("phase_aligners", "phase_serra09",
                                      "phase_early_snf", "phase_serving",
                                      "phase_sharded")):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _l=letter: stub(*a, _l=_l))
    return chip_smoke, calls, fail


@pytest.mark.parametrize("argv,phases,count", [
    (["--four"], ["f"], 4),
    ([], ["b", "c", "d", "e"], 1),
])
def test_chip_smoke_phase_selection(smoke, capsys, argv, phases, count):
    """--four runs only the sharded phase; no option runs all of b-e."""
    chip_smoke, calls, _ = smoke
    assert chip_smoke.main(argv) == 0
    assert calls == phases
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"ok": True, "device": {
        "platform": "gpu", "kind": "fake card", "count": count}}


def test_chip_smoke_failed_phase_fails_the_run(smoke, capsys):
    """A failing phase is reported and fails the run, the later phases
    still run, and no "ok" line is printed."""
    chip_smoke, calls, fail = smoke
    fail.add("c")
    assert chip_smoke.main([]) != 0
    assert calls == ["b", "c", "d", "e"]
    out = capsys.readouterr().out
    assert '"ok"' not in out
    assert "phase c broke" in out and "FAILED phases: c" in out


def test_chip_smoke_rejects_unknown_options(smoke):
    chip_smoke, calls, _ = smoke
    with pytest.raises(SystemExit):
        chip_smoke.main(["--phases", "b"])
    assert calls == []


# -------------------------------------------- the package's former name

FORMER_NAME = "acoss_tpu"

def test_former_package_name_aliases_the_same_modules():
    import importlib

    import acoss_jax.cli
    import acoss_jax.ops.alignment

    old = FORMER_NAME
    assert importlib.import_module(old + ".cli") is acoss_jax.cli
    mod = importlib.import_module(old + ".ops.alignment")
    assert mod is acoss_jax.ops.alignment
    assert mod.__spec__.name == "acoss_jax.ops.alignment"
    assert importlib.import_module(old).__version__ == acoss_jax.__version__


def test_former_package_name_runs_the_cli():
    r = _run(["-m", FORMER_NAME, "--help"],
             env_extra={"JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert "benchmark" in r.stdout and "query" in r.stdout


# ---------------------------------------------------- main-path imports

_BLOCK = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pandas", "sklearn", "h5py"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, _Block())
from acoss_jax import cli
rc = cli.main(sys.argv[1:])
bad = [m for m in ("pandas", "sklearn", "h5py") if m in sys.modules]
print("RESULT", rc, bad)
"""


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    from acoss_jax.data import make_synthetic_dataset

    d = tmp_path_factory.mktemp("corpus")
    fs = make_synthetic_dataset(n_cliques=4, clique_size=2, n_states=24,
                                base_duration=30.0, seed=2)
    fs.save(str(d / "c.npz"))
    fs.subset(np.arange(2)).save(str(d / "q.npz"))
    return d


@pytest.mark.parametrize("cmd", ["benchmark", "query"])
def test_main_path_needs_no_pandas_sklearn_h5py(tiny_corpus, cmd):
    c, q = str(tiny_corpus / "c.npz"), str(tiny_corpus / "q.npz")
    argv = {"benchmark": ["benchmark", "-a", "Serra09", "-d", c,
                          "--cachedir", str(tiny_corpus / "cache"),
                          "--no-checkpoint"],
            "query": ["query", "-a", "Serra09", "-d", c, "-q", q]}[cmd]
    r = _run(["-c", _BLOCK, *argv], cwd=tiny_corpus,
             env_extra={"PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "RESULT 0 []" in r.stdout


# --------------------------------------------------- matmul precision

def _dot_precisions(closed):
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "jaxpr"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)
    walk(closed.jaxpr)
    return out


def _case(name):
    from acoss_jax.features import chord, chroma
    from acoss_jax.ops import structure

    f32 = jnp.float32
    if name == "cqt":
        return lambda y: chroma._cqt_jax(y, 8000, 256, 100.0, 12, 12, 1024), \
            (jnp.ones(4096, f32),)
    if name == "chord":
        T = chord.chord_templates()
        C = T.shape[0]
        return chord._chord_posteriors_padded, (
            jnp.ones((16, 12), f32), jnp.asarray(T, f32),
            jnp.zeros((C, C), f32), jnp.asarray(0.08, f32),
            jnp.ones(16, bool))
    if name == "blur":
        return lambda W, n: structure.resize_dynamic_batch(W, n, 8), (
            jnp.ones((2, 32, 32), f32), jnp.array([32, 20], jnp.int32))
    return lambda x, w, key: structure._kmeans_labels(x, w, 3, key, 2, 4), (
        jnp.ones((20, 4), f32), jnp.ones(20, bool), jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", ["cqt", "chord", "blur", "kmeans"])
def test_parity_matmuls_pin_highest_precision(name):
    """No TF32 on the GPU for these parity paths: every matmul states
    precision HIGHEST."""
    fn, args = _case(name)
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args))
    assert precs, "expected at least one matmul"
    hi = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and tuple(p) == (hi, hi), p
