"""Method registry (port of gssr_tpu/configs/methods.py).

The `3dgs`, `2dgs`, `pgsr` and `scaffold-gs` presets are ported; the
reference's other five methods are listed so that asking for one fails
with a clear message until their slice lands.
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


def _twodgs():
    from gssr_tpu_torch.models.twod import TwoDGaussianConfig
    from gssr_tpu_torch.scene.twodgs import TwoDGSSceneConfig
    return Config(
        method_name="2dgs",
        scene=TwoDGSSceneConfig(
            dataloader=DataLoaderConfig(),
            gaussians=TwoDGaussianConfig(),
            depth_ratio=0.0, lambda_normal=0.05, lambda_dist=0.0))


def _pgsr():
    from gssr_tpu_torch.models.pgsr import PGSRGaussianConfig
    from gssr_tpu_torch.scene.pgsr import PGSRSceneConfig
    return Config(
        method_name="pgsr",
        scene=PGSRSceneConfig(
            dataloader=DataLoaderConfig(),
            gaussians=PGSRGaussianConfig()))


def _scaffold():
    from gssr_tpu_torch.models.scaffold import ScaffoldGaussianConfig
    from gssr_tpu_torch.scene.scaffold import ScaffoldSceneConfig
    return Config(
        method_name="scaffold-gs",
        scene=ScaffoldSceneConfig(
            dataloader=DataLoaderConfig(),
            gaussians=ScaffoldGaussianConfig(),
            lambda_scaling=0.01))


METHOD_FACTORIES: Dict[str, Callable[[], Config]] = {"3dgs": _vanilla,
                                                     "2dgs": _twodgs,
                                                     "pgsr": _pgsr,
                                                     "scaffold-gs": _scaffold}

NOT_YET_PORTED = ("octree-gs", "scaffold-2dgs", "octree-2dgs",
                  "scaffold-pgsr", "octree-pgsr")

DESCRIPTIONS = {"3dgs": "Vanilla 3D Gaussian Splatting",
                "2dgs": "2DGS surfel splatting",
                "pgsr": "PGSR planar splatting with multi-view regularization",
                "scaffold-gs": "Scaffold-GS anchors with MLP-decoded neural "
                               "gaussians"}


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
    from gssr_tpu_torch.scene.pgsr import PGSRScene, PGSRSceneConfig
    from gssr_tpu_torch.scene.scaffold import (
        ScaffoldScene,
        ScaffoldSceneConfig,
    )
    from gssr_tpu_torch.scene.twodgs import TwoDGSScene, TwoDGSSceneConfig
    from gssr_tpu_torch.scene.vanilla import VanillaScene, VanillaSceneConfig
    scenes = {VanillaSceneConfig: VanillaScene,
              TwoDGSSceneConfig: TwoDGSScene,
              PGSRSceneConfig: PGSRScene,
              ScaffoldSceneConfig: ScaffoldScene}
    cls = scenes.get(type(config.scene))
    if cls is None:
        raise NotImplementedError(
            f"no ported scene for {type(config.scene).__name__}")
    return cls(config.scene, config.source_path, device, eval=config.eval,
               seed=config.machine.seed, **kwargs)


def config_classes():
    """Name -> class map for YAML round trips."""
    from gssr_tpu_torch.models.pgsr import PGSRGaussianConfig
    from gssr_tpu_torch.models.scaffold import ScaffoldGaussianConfig
    from gssr_tpu_torch.models.twod import TwoDGaussianConfig
    from gssr_tpu_torch.models.vanilla import VanillaGaussianConfig
    from gssr_tpu_torch.scene.pgsr import PGSRSceneConfig
    from gssr_tpu_torch.scene.scaffold import ScaffoldSceneConfig
    from gssr_tpu_torch.scene.twodgs import TwoDGSSceneConfig
    from gssr_tpu_torch.scene.vanilla import VanillaSceneConfig
    classes = [Config, MachineConfig, TrainerConfig, DataLoaderConfig,
               VanillaGaussianConfig, VanillaSceneConfig,
               TwoDGaussianConfig, TwoDGSSceneConfig, PGSRGaussianConfig,
               PGSRSceneConfig, ScaffoldGaussianConfig, ScaffoldSceneConfig]
    return {c.__name__: c for c in classes}
