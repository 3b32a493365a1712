"""The port's GNN config modules equal the reference's dicts (the
published widths that ``chip_smoke.py`` and the examples read)."""
import importlib

import pytest

NAMES = {"gcn": ("GCN", "CONFIG", "REDUCED"),
         "gin": ("GIN", "CONFIG", "REDUCED"),
         "gat": ("GAT", "CONFIG", "REDUCED", "GAT_MH")}


@pytest.mark.parametrize("module", sorted(NAMES))
def test_gnn_configs_equal_reference(module):
    ref = importlib.import_module(f"repro.configs.{module}")
    port = importlib.import_module(f"repro_torch.configs.{module}")
    public = lambda m: {k for k in vars(m) if k.isupper()}
    assert public(port) == public(ref) == set(NAMES[module])
    for name in NAMES[module]:
        assert getattr(port, name) == getattr(ref, name), name
