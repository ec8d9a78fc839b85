"""The port stands alone: it imports neither JAX nor the reference package, and
its entry points run on the card unless the caller asks for the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro")
LOCAL, REMOTE = 0, 1


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {list(_port_modules())!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120, check=True)
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.serving.engine" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", [*sorted(PORT.rglob("*.py")), ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert bad == []


def _tiny_dense():
    from repro_torch.configs import get_config

    return get_config("gemma3-1b").reduced()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the defaults run there")
    from repro_torch.core.api import CXLSession
    from repro_torch.core.emucxl import EmuCXL
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import ServingEngine

    cfg = _tiny_dense()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CXLSession()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmuCXL().init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(torch.Generator(), cfg)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(params, cfg)


def test_other_families_name_their_roadmap_item():
    """Every family runs on the port; the MoE layer's mesh variants do not
    yet, and name the item that ports them."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import ModelOptions, forward, init_params

    cfg = get_config("olmoe-1b-7b").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        forward(params, cfg, torch.zeros((1, 4), dtype=torch.int32),
                ModelOptions(moe_impl="ep_ff"))


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.core import emucxl
    from repro_torch.launch import serve

    try:
        eng = serve.main(["--device", "cpu", "--requests", "2", "--slots", "1",
                          "--max-batch", "2", "--prompt-len", "4", "--max-new", "3"])
    finally:
        if emucxl.default_instance()._initialized:
            emucxl.default_instance().exit()
    assert all(len(r.generated) == 3 for r in eng.requests.values())
    assert eng.preemptions > 0 and eng.decode_batches > 0
    assert "tier stats" in capsys.readouterr().out
    assert serve.parse_args(["--no-reduced"]).reduced is False


@pytest.mark.cuda
def test_tiers_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.api import CXLSession

    payload = np.arange(4096, dtype=np.uint8) % 251
    with CXLSession(1 << 20, 1 << 22) as s:
        loc, rem = s.alloc(4096, LOCAL), s.alloc(4096, REMOTE)
        allocs = s.lib.allocations()
        assert allocs[loc.address].data.is_cuda
        assert allocs[rem.address].data.is_pinned()
        assert s.lib.memory_kind(REMOTE) == "pinned_host"
        loc.write(payload)
        loc = loc.migrate(REMOTE)               # a real device -> pinned-host DMA
        assert np.array_equal(loc.read(0, 4096), payload)
