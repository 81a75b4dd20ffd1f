"""chip_smoke.py's parity logic, run on the CPU: the fixture-scale golden
phase is called directly (main() insists on a GPU)."""

import importlib.util
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_golden_phase_on_cpu(fixtures_dir, golden_dir, tmp_path):
    smoke = _smoke()
    before = {k: os.environ.get(k) for k in
              ("GAT_RESCORE", "GAT_PAIR_TILES", "GAT_COMBINE")}
    times = smoke.golden_phase(fixtures_dir, golden_dir, str(tmp_path))
    assert len(times) == len(smoke.GOLDEN_VARIANTS)
    assert all(len(t) == 3 for t in times.values())
    # the phase restores the environment it changed
    assert {k: os.environ.get(k) for k in before} == before


def test_golden_phase_catches_a_differing_output(fixtures_dir, golden_dir,
                                                 tmp_path):
    smoke = _smoke()
    bad = tmp_path / "golden"
    bad.mkdir()
    for name in os.listdir(golden_dir):
        src = os.path.join(golden_dir, name)
        if os.path.isfile(src):
            (bad / name).write_bytes(open(src, "rb").read())
    net = bad / "chainNetRescore.query.net"
    net.write_bytes(net.read_bytes() + b"\n")
    with pytest.raises(AssertionError, match="chainNetRescore.query.net"):
        smoke.golden_phase(fixtures_dir, str(bad), str(tmp_path / "w"),
                           variants=(("xla", {}),))
