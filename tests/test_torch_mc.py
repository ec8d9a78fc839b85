"""The port's emucxl model checker (``repro_torch.core.mc``) against the
reference's: the same litmus verdicts, exploration counts and enumerator
state spaces, the seeded mutation caught in both, and an import that loads
neither torch nor numpy."""

import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import mc as r_mc
from repro_torch.core import mc as t_mc

ROOT = Path(__file__).resolve().parent.parent


def _verdict(result):
    return {"name": result.program.name, "explored": result.explored,
            "naive": result.naive, "racy_schedules": result.racy_schedules,
            "racy": result.racy, "witness_racy": result.witness_racy,
            "witness_free": result.witness_free, "violations": result.violations,
            "ok": result.ok}


def test_corpus_is_the_reference_corpus():
    assert [str(p) for p in t_mc.CORPUS] == [str(p) for p in r_mc.CORPUS]
    assert [p.name for p in t_mc.CORPUS] == [p.name for p in r_mc.CORPUS]


@pytest.mark.parametrize("name", [p.name for p in r_mc.CORPUS])
def test_check_program_matches_reference(name):
    ref = r_mc.check_program(r_mc.find_program(name))
    port = t_mc.check_program(t_mc.find_program(name))
    assert _verdict(port) == _verdict(ref)
    assert port.ok and port.racy == port.program.expect_race


def test_seeded_mutation_is_caught_in_both():
    results = []
    for mc in (r_mc, t_mc):
        program = mc.find_program("private_rmw")
        assert mc.check_program(program).ok
        mutated = mc.check_program(program, segment_factory=mc.seeded_mutation_factory)
        assert any("rollback inverse" in v for v in mutated.violations)
        results.append(_verdict(mutated))
    assert results[0] == results[1]


@pytest.mark.parametrize("kw", [dict(consistency="eager"),
                                dict(consistency="release", wc_capacity=1)],
                         ids=["eager", "release-wc1"])
def test_enumerate_protocol_counts_match(kw):
    ref = r_mc.enumerate_protocol(3, 2, **kw)
    port = t_mc.enumerate_protocol(3, 2, **kw)
    assert (port.states, port.transitions, port.violations, port.ok) == \
        (ref.states, ref.transitions, ref.violations, ref.ok)
    if kw["consistency"] == "eager":
        assert port.states == 14 ** 2


def test_mc_import_loads_neither_torch_nor_numpy():
    code = ("import sys; import repro_torch.core.mc; "
            "bad = [m for m in sys.modules "
            " if m.split('.')[0] in ('numpy', 'torch', 'jax', 'jaxlib', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
