"""The port reads a config.yml that gssr_tpu wrote: for the ported presets
the fields both packages have come out equal, each field the port has no
counterpart for is dropped with one printed note naming it, and a value of
one that would change what the port computes raises, naming the field."""
import pytest

from gssr_tpu_torch.configs.base import FOREIGN_FIELDS


def _strip(node, drop):
    """A plain config tree without the fields `drop` maps each class name
    to."""
    if isinstance(node, dict) and "__dataclass__" in node:
        gone = drop.get(node["__dataclass__"], ())
        return {k: _strip(v, drop) for k, v in node.items() if k not in gone}
    if isinstance(node, list):
        return [_strip(v, drop) for v in node]
    return node


def _write(tmp_path, method, **machine):
    from gssr_tpu.configs.base import save_config_yaml
    from gssr_tpu.configs.methods import get_method_config
    config = get_method_config(method)
    config.source_path = "/data/scene"
    config.output_path = str(tmp_path / "out")
    config.timestamp = "2026-01-01_000000"
    for k, v in machine.items():
        setattr(config.machine, k, v)
    path = tmp_path / "config.yml"
    save_config_yaml(config, path)
    return config, path


@pytest.mark.parametrize("method", ["3dgs", "2dgs", "pgsr"])
def test_a_gssr_tpu_config_loads_in_the_port(method, tmp_path, capsys):
    from gssr_tpu.configs.base import _to_plain as j_plain
    from gssr_tpu_torch.configs.base import _to_plain as t_plain
    from gssr_tpu_torch.configs.base import load_config_yaml
    config, path = _write(tmp_path, method)
    loaded = load_config_yaml(path)
    notes = capsys.readouterr().out.splitlines()
    # the port's tree, without its own machine.device, is gssr_tpu's
    # without the fields the port has no counterpart for
    assert _strip(t_plain(loaded), {"MachineConfig": ("device",)}) == \
        _strip(j_plain(config), FOREIGN_FIELDS)
    assert loaded.machine.device == "cuda"
    written = {f"{name}.{k}" for name, fields in FOREIGN_FIELDS.items()
               for k in fields if name in (
                   "Config", "MachineConfig", "TrainerConfig",
                   type(config.scene).__name__)}
    assert len(notes) == len(written)
    for field in written:
        assert sum(field in n for n in notes) == 1, (field, notes)


@pytest.mark.parametrize("field,value", [("num_devices", 4),
                                         ("parallel", "dp"),
                                         ("dist_init", True)])
def test_a_multi_device_gssr_tpu_config_raises(field, value, tmp_path):
    from gssr_tpu_torch.configs.base import load_config_yaml
    _, path = _write(tmp_path, "3dgs", **{field: value})
    with pytest.raises(ValueError, match=f"MachineConfig.{field}"):
        load_config_yaml(path)
