"""DeviceChainScorer's mode choice and the compile-cache placement."""

import os

import jax
import pytest

from genomealignmenttools_tpu.formats.gapcalc import gap_calc_default
from genomealignmenttools_tpu.formats.scorematrix import score_scheme_default
from genomealignmenttools_tpu.ops import rescore


def _scorer(fixtures_dir, mode):
    from genomealignmenttools_tpu.device.genome import Genome
    return rescore.DeviceChainScorer(
        score_scheme_default(), gap_calc_default(),
        Genome(os.path.join(fixtures_dir, "target.2bit")),
        Genome(os.path.join(fixtures_dir, "query.2bit")), mode=mode)


@pytest.mark.parametrize("backend,want", [("gpu", "pair"), ("cpu", "xla")])
def test_auto_mode_picks_measured_mode(backend, want, fixtures_dir,
                                       monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.delenv("GAT_RESCORE", raising=False)
    assert rescore.auto_device_mode() == want
    assert _scorer(fixtures_dir, None).mode == want


def test_auto_mode_unmeasured_backend_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(ValueError, match="no measured rescore mode"):
        rescore.auto_device_mode()


@pytest.mark.parametrize("mode", ["pallas", "fused", ""])
def test_unknown_rescore_mode_raises(mode, fixtures_dir, monkeypatch):
    """Removed and misspelt modes fail loudly instead of falling back."""
    with pytest.raises(ValueError, match="unknown rescore mode"):
        _scorer(fixtures_dir, mode)
    monkeypatch.setenv("GAT_RESCORE", mode or "bogus")
    with pytest.raises(ValueError, match="unknown rescore mode"):
        _scorer(fixtures_dir, None)


@pytest.fixture
def cache_dir_restored():
    saved = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_defaults_to_checkout(cache_dir_restored,
                                            monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    rescore._init_jax()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        repo, ".jax_cache")
    assert rescore.DEFAULT_JAX_CACHE == os.path.join(repo, ".jax_cache")


def test_compile_cache_honours_env(cache_dir_restored, monkeypatch,
                                   tmp_path):
    """JAX_COMPILATION_CACHE_DIR (read by jax itself) wins: nothing is
    set in code, not even over a directory configured earlier."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    rescore._init_jax()
    assert jax.config.jax_compilation_cache_dir is None
    jax.config.update("jax_compilation_cache_dir", str(tmp_path / "user"))
    rescore._init_jax()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "user")
