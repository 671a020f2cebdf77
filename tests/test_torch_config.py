"""The port's model configs are field-for-field the JAX package's."""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402


def test_arch_registry_matches():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.list_archs() == jconfigs.list_archs()


@pytest.mark.parametrize("which", ["get", "get_smoke"])
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_matches_reference(arch, which):
    j = getattr(jconfigs, which)(arch)
    t = getattr(tconfigs, which)(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert (t.q_dim, t.kv_dim) == (j.q_dim, j.kv_dim)
