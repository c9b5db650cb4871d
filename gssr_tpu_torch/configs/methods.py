"""Method registry (port of gssr_tpu/configs/methods.py).

The `3dgs` preset is ported; the reference's other eight methods are
listed so that asking for one fails with a clear message until their
slice lands.
"""
from __future__ import annotations

from typing import Callable, Dict

from gssr_tpu_torch.configs.base import (
    Config,
    DataLoaderConfig,
    MachineConfig,
    TrainerConfig,
)


def _vanilla():
    from gssr_tpu_torch.models.vanilla import VanillaGaussianConfig
    from gssr_tpu_torch.scene.vanilla import VanillaSceneConfig
    return Config(
        method_name="3dgs",
        scene=VanillaSceneConfig(
            dataloader=DataLoaderConfig(shuffle=True, llffhold=8,
                                        resolution=-1, images="images",
                                        white_background=False),
            gaussians=VanillaGaussianConfig(max_sh_degree=3,
                                            percent_dense=0.01),
            random_background=False,
            lambda_dssim=0.2))


METHOD_FACTORIES: Dict[str, Callable[[], Config]] = {"3dgs": _vanilla}

NOT_YET_PORTED = ("2dgs", "scaffold-gs", "octree-gs", "scaffold-2dgs",
                  "octree-2dgs", "pgsr", "scaffold-pgsr", "octree-pgsr")

DESCRIPTIONS = {"3dgs": "Vanilla 3D Gaussian Splatting"}


def get_method_config(name: str) -> Config:
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"method {name!r} is not yet ported to gssr_tpu_torch (only "
            f"{sorted(METHOD_FACTORIES)}); train it with gssr_tpu's "
            f"train.py meanwhile")
    if name not in METHOD_FACTORIES:
        raise KeyError(f"unknown method {name!r}; available: "
                       f"{sorted(METHOD_FACTORIES)}")
    return METHOD_FACTORIES[name]()


def build_scene(config: Config, device, **kwargs):
    """Instantiate the scene matching the scene config's type."""
    from gssr_tpu_torch.scene.vanilla import VanillaScene, VanillaSceneConfig
    if not isinstance(config.scene, VanillaSceneConfig):
        raise NotImplementedError(
            f"no ported scene for {type(config.scene).__name__}")
    return VanillaScene(config.scene, config.source_path, device,
                        eval=config.eval, seed=config.machine.seed, **kwargs)


def config_classes():
    """Name -> class map for YAML round trips."""
    from gssr_tpu_torch.models.vanilla import VanillaGaussianConfig
    from gssr_tpu_torch.scene.vanilla import VanillaSceneConfig
    classes = [Config, MachineConfig, TrainerConfig, DataLoaderConfig,
               VanillaGaussianConfig, VanillaSceneConfig]
    return {c.__name__: c for c in classes}
