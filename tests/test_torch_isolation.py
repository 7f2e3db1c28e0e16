"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
its entry points refuse to fall back to the CPU quietly, its kernels' launch
counters count CUDA launches only, and ``chip_smoke.py`` refuses to run
without a GPU or without the repository."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _run(code: str, cwd=ROOT, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'repro' or m.startswith('repro.')\n"
        "       or m == 'jax' and sys.modules[m] is not None\n"
        "       or m.startswith('jax.') or m.startswith('jaxlib')]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    assert len(names) >= 20
    # the policy path's modules are among those imported without jax
    assert {"repro_torch.core.hrm", "repro_torch.core.policy",
            "repro_torch.core.cgopipe", "repro_torch.launch.serve"} <= names


@pytest.mark.parametrize("arch", ["gemma2-2b", "glm4-9b", "olmo-1b",
                                  "moonshot-v1-16b-a3b", "whisper-small",
                                  "paligemma-3b"])
def test_family_configs_import_without_jax(arch):
    """Each config module of the four families of the attention slice, and
    of whisper and paligemma, imports, and resolves through
    ``get_config``, where jax cannot be imported, and pulls in no module
    of the JAX package."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "from repro_torch.configs import _ARCH_MODULES, get_config\n"
        f"mod = importlib.import_module('repro_torch.configs.' "
        f"+ _ARCH_MODULES[{arch!r}])\n"
        f"cfg = get_config({arch!r})\n"
        "assert cfg is mod.CONFIG and cfg.param_count() > 0\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'repro' or m.startswith('repro.')\n"
        "       or m.startswith('jax.') or m.startswith('jaxlib')]\n"
        "assert not bad, bad\n"
        "print(cfg.name)\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == arch


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                        r"from\s+(jax|repro)(\s|\.)(?!_))", re.M)


TRAINING_MODULES = ["repro_torch.training.losses",
                    "repro_torch.training.optimizer",
                    "repro_torch.training.train_step",
                    "repro_torch.training.trainer",
                    "repro_torch.data.pipeline",
                    "repro_torch.runtime.checkpoint",
                    "repro_torch.launch.train",
                    "repro_torch.kernels.flash_prefill"]


@pytest.fixture(scope="module")
def training_imports():
    """One process where jax cannot be imported imports the training
    slice's modules in turn; for each, the modules of jax or of the JAX
    package loaded by then."""
    code = (
        "import sys, importlib, json, torch\n"
        "sys.modules['jax'] = None\n"
        "out = {}\n"
        f"for name in {TRAINING_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "    out[name] = [m for m in sys.modules\n"
        "                 if m == 'repro' or m.startswith('repro.')\n"
        "                 or m.startswith('jax.') or m.startswith('jaxlib')]\n"
        "from repro_torch.kernels import flash_prefill\n"
        "out['fn'] = issubclass(flash_prefill.FlashPrefillFn,\n"
        "                       torch.autograd.Function)\n"
        "print(json.dumps(out))\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_import_without_jax(training_imports, module):
    """Each module of the training slice, and the flash_prefill wrapper
    with its autograd Function, imports where jax cannot be imported and
    pulls in no module of the JAX package."""
    assert training_imports[module] == []
    assert training_imports["fn"] is True


def test_train_launcher_runs_without_jax():
    """``repro_torch.launch.train --device cpu`` in a process where jax
    cannot be imported: a few steps of mixtral's smoke config with finite
    metrics; without ``--device`` and without a GPU the trainer raises."""
    code = (
        "import sys, json, math, torch\n"
        "sys.modules['jax'] = None\n"
        "from repro_torch.launch import train\n"
        "args = ['--arch', 'mixtral-8x7b', '--smoke', '--steps', '3',\n"
        "        '--batch-size', '2', '--seq-len', '16']\n"
        "out = train.main(args + ['--device', 'cpu'])\n"
        "assert all(math.isfinite(v) for v in out['final'].values())\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        train.main(args)\n"
        "    except RuntimeError as e:\n"
        "        assert 'device' in str(e)\n"
        "    else:\n"
        "        raise AssertionError('trained on the CPU unasked')\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print(json.dumps(out['final']))\n")
    r = _run(code, timeout=300)
    assert r.returncode == 0, r.stderr
    final = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(final) == {"loss", "lm_loss", "aux_loss", "grad_norm", "lr"}


def test_sources_do_not_import_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [SMOKE]
    assert len(files) > 20
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)


def test_entry_points_refuse_cpu_without_being_asked():
    code = (
        "import dataclasses, sys, torch\n"
        "if torch.cuda.is_available():\n"
        "    print('gpu'); sys.exit(0)\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import kvcache, params\n"
        "from repro_torch.serving.engine import Engine, EngineConfig\n"
        "cfg = get_config('qwen2.5-3b').smoke()\n"
        "p = params.init_params(cfg, torch.Generator(), device='cpu')\n"
        "calls = [lambda: Engine(cfg, p, EngineConfig()),\n"
        "         lambda: kvcache.init_cache(cfg, 1, 16),\n"
        "         lambda: params.init_params(cfg, torch.Generator())]\n"
        "for c in calls:\n"
        "    try:\n"
        "        c()\n"
        "    except RuntimeError as e:\n"
        "        assert 'device' in str(e)\n"
        "    else:\n"
        "        raise AssertionError('ran on the CPU without device=cpu')\n"
        "print('refused')\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() in ("refused", "gpu")


def test_launch_counters_stay_zero_on_cpu_tensors():
    from repro_torch.configs import get_config
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import Engine, EngineConfig
    saved = ops.launch_counts()
    ops.reset_launch_counts()
    try:
        cfg = get_config("mixtral-8x7b").smoke()
        eng = Engine(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"),
                     EngineConfig(ubatch=2, num_ubs=1, max_seq=32),
                     ExecPolicy(moe_impl="grouped", use_kernels=True),
                     device="cpu")
        rng = np.random.default_rng(0)
        for n in (3, 9):
            eng.submit(rng.integers(2, cfg.vocab_size, n), 4)
        out = eng.run_until_idle()
        assert [len(v) for v in out.values()] == [4, 4]
        assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    finally:
        for name, fn in ops.KERNELS.items():
            fn.launches = saved[name]


def _launch(module: str, extra=()):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", module, "--smoke", "--hw", "l4",
         "--requests", "4", *extra], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)


def test_launcher_matches_the_reference_advice_and_serves():
    """``repro_torch.launch.serve`` prints the HRM advice that
    ``repro.launch.serve`` prints with the same flags, then serves every
    request on the CPU and reports them done in its JSON line."""
    port = _launch("repro_torch.launch.serve", ("--device", "cpu"))
    ref = _launch("repro.launch.serve")
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr

    def advice(out):
        return [ln for ln in out.splitlines()
                if ln.startswith("[serve] HRM policy")]
    assert advice(port.stdout) == advice(ref.stdout)
    assert len(advice(port.stdout)) == 1
    res = json.loads(port.stdout.strip().splitlines()[-1])
    assert res["requests"] == res["done"] == 4
    assert res["tokens"] == 4 * 16 and res["device"] == "cpu"


def test_launcher_paged_serves_without_jax():
    """``repro_torch.launch.serve --paged --device cpu`` in a process where
    jax cannot be imported: the whole-layer paged engine serves the same
    requests and tokens as the resident one."""
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        "from repro_torch.launch import serve\n"
        "args = ['--smoke', '--hw', 'l4', '--requests', '4', "
        "'--device', 'cpu']\n"
        "res = [serve.main(args + extra) for extra in ([], ['--paged'])]\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print(json.dumps(res))\n")
    r = _run(code, timeout=300)
    assert r.returncode == 0, r.stderr
    plain, paged = json.loads(r.stdout.strip().splitlines()[-1])
    assert not plain["paged"] and paged["paged"]
    for k in ("requests", "done", "tokens"):
        assert paged[k] == plain[k]
    assert paged["requests"] == paged["done"] == 4


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, where):
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(SMOKE.read_text())
        cwd, script = tmp_path, tmp_path / "chip_smoke.py"
    elif torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would really run")
    else:
        cwd, script = ROOT, SMOKE
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
