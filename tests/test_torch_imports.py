"""The port stands alone: `repro_torch` and chip_smoke.py import neither
JAX nor anything of the JAX package `repro`, and the entry points refuse
to fall back to the CPU quietly."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import resolve_device  # noqa: E402
from repro_torch.sim import engine, topology, workload  # noqa: E402
from repro_torch.sim.config import PRESETS, SimConfig  # noqa: E402

pytestmark = pytest.mark.tier1

REPO = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b[\w.]*\s+import)",
    re.MULTILINE)


def test_modules_import_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(REPO / 'src')!r})\n"
        "import repro_torch.sim.engine, repro_torch.kernels.bfc_step.ops\n"
        "import repro_torch.testing, repro_torch.sim.metrics\n"
        "import repro_torch.sim.trace.golden, repro_torch.core.backpressure\n"
        "import repro_torch.configs, repro_torch.models.model\n"
        "import repro_torch.models.attention, repro_torch.models.rglru\n"
        "import repro_torch.models.layers, repro_torch.models.nn\n"
        "import repro_torch.runtime.steps, repro_torch.runtime.serving\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.rglru.ops\n"
        "import repro_torch.kernels.rwkv6.ops, repro_torch.models.rwkv6\n"
        "import repro_torch.runtime.lm_profile\n"
        "from repro_torch.launch import serve\n"
        "assert serve.build_parser().parse_args([]).device == 'cuda'\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_has_no_jax_or_repro_import(path):
    found = FORBIDDEN.findall(path.read_text())
    assert not found, f"{path} imports {found}"


def test_engine_run_refuses_to_fall_back_to_cpu(monkeypatch):
    """Without a card, the default device raises instead of quietly
    running on the CPU; the CPU is only used when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clos = topology.ClosParams(n_servers=4, n_tor=2, n_spine=1)
    topo = topology.build(clos)
    flows = workload.generate(topo, workload.WorkloadParams(
        workload="uniform", seed=1), 3)
    cfg = SimConfig(proto=PRESETS["bfc"], clos=clos)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.run(topo, flows, cfg, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    st, emits = engine.run(topo, flows, cfg, 16, device="cpu")
    assert emits.shape == (16, 3) and int(st.t) == 16
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_lm_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """The LM entry points default to the card and raise without one."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.reduced("recurrentgemma-2b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "recurrentgemma-2b"])
    assert serve.build_parser().parse_args([]).device == "cuda"
    assert serve.build_parser().parse_args(["--no-reduced"]).reduced is False
    srv, done = serve.main(["--arch", "recurrentgemma-2b", "--device", "cpu",
                            "--requests", "3", "--max-new", "2"])
    assert srv.stats.completed == 3 and all(len(r.out) == 2 for r in done)


def test_chip_smoke_refuses_without_cuda(monkeypatch):
    """chip_smoke.py exits non-zero and prints no result without a card."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch, runpy\n"
         "torch.cuda.is_available = lambda: False\n"
         f"sys.argv = [{str(REPO / 'chip_smoke.py')!r}]\n"
         f"runpy.run_path({str(REPO / 'chip_smoke.py')!r}, "
         "run_name='__main__')\n"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
