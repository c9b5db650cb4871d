"""Method registry (port of gssr_tpu/configs/methods.py): the nine
method presets, with the reference's fields."""
from __future__ import annotations

from typing import Callable, Dict

from gssr_tpu_torch.configs.base import (
    Config,
    DataLoaderConfig,
    MachineConfig,
    PartitionConfig,
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


def _octree():
    from gssr_tpu_torch.models.octree import OctreeGaussianConfig
    from gssr_tpu_torch.scene.octree import OctreeSceneConfig
    return Config(
        method_name="octree-gs",
        scene=OctreeSceneConfig(
            dataloader=DataLoaderConfig(),
            gaussians=OctreeGaussianConfig()))


def _scaffold_2dgs():
    from gssr_tpu_torch.models.scaffold import ScaffoldGaussianConfig
    from gssr_tpu_torch.scene.scaffold_2dgs import Scaffold2DGSSceneConfig
    return Config(
        method_name="scaffold-2dgs",
        scene=Scaffold2DGSSceneConfig(
            dataloader=DataLoaderConfig(),
            gaussians=ScaffoldGaussianConfig()))


def _octree_2dgs():
    from gssr_tpu_torch.models.octree import OctreeGaussianConfig
    from gssr_tpu_torch.scene.octree_2dgs import Octree2DGSSceneConfig
    return Config(
        method_name="octree-2dgs",
        scene=Octree2DGSSceneConfig(
            dataloader=DataLoaderConfig(),
            gaussians=OctreeGaussianConfig()))


def _scaffold_pgsr():
    from gssr_tpu_torch.models.scaffold import ScaffoldGaussianConfig
    from gssr_tpu_torch.scene.scaffold_pgsr import ScaffoldPGSRSceneConfig
    return Config(
        method_name="scaffold-pgsr",
        scene=ScaffoldPGSRSceneConfig(
            dataloader=DataLoaderConfig(),
            gaussians=ScaffoldGaussianConfig()))


def _octree_pgsr():
    from gssr_tpu_torch.models.octree import OctreeGaussianConfig
    from gssr_tpu_torch.scene.octree_pgsr import OctreePGSRSceneConfig
    return Config(
        method_name="octree-pgsr",
        scene=OctreePGSRSceneConfig(
            dataloader=DataLoaderConfig(),
            gaussians=OctreeGaussianConfig()))


METHOD_FACTORIES: Dict[str, Callable[[], Config]] = {
    "3dgs": _vanilla,
    "2dgs": _twodgs,
    "scaffold-gs": _scaffold,
    "octree-gs": _octree,
    "scaffold-2dgs": _scaffold_2dgs,
    "octree-2dgs": _octree_2dgs,
    "pgsr": _pgsr,
    "scaffold-pgsr": _scaffold_pgsr,
    "octree-pgsr": _octree_pgsr,
}

DESCRIPTIONS = {
    "3dgs": "Vanilla 3D Gaussian Splatting",
    "scaffold-gs": "Scaffold-GS anchors with MLP-decoded neural gaussians",
    "octree-gs": "Octree-GS (level-of-detail anchors)",
    "2dgs": "2DGS surfel splatting",
    "scaffold-2dgs": "Scaffold-GS + 2DGS",
    "octree-2dgs": "Octree-GS + 2DGS",
    "pgsr": "PGSR planar splatting with multi-view regularization",
    "scaffold-pgsr": "Scaffold-GS + PGSR",
    "octree-pgsr": "Octree-GS + PGSR",
}


def get_method_config(name: str) -> Config:
    if name not in METHOD_FACTORIES:
        raise KeyError(f"unknown method {name!r}; available: "
                       f"{sorted(METHOD_FACTORIES)}")
    return METHOD_FACTORIES[name]()


def build_scene(config: Config, device, **kwargs):
    """Instantiate the scene matching the scene config's type."""
    from gssr_tpu_torch.scene.octree import OctreeScene, OctreeSceneConfig
    from gssr_tpu_torch.scene.octree_2dgs import (
        Octree2DGSScene,
        Octree2DGSSceneConfig,
    )
    from gssr_tpu_torch.scene.octree_pgsr import (
        OctreePGSRScene,
        OctreePGSRSceneConfig,
    )
    from gssr_tpu_torch.scene.pgsr import PGSRScene, PGSRSceneConfig
    from gssr_tpu_torch.scene.scaffold import (
        ScaffoldScene,
        ScaffoldSceneConfig,
    )
    from gssr_tpu_torch.scene.scaffold_2dgs import (
        Scaffold2DGSScene,
        Scaffold2DGSSceneConfig,
    )
    from gssr_tpu_torch.scene.scaffold_pgsr import (
        ScaffoldPGSRScene,
        ScaffoldPGSRSceneConfig,
    )
    from gssr_tpu_torch.scene.twodgs import TwoDGSScene, TwoDGSSceneConfig
    from gssr_tpu_torch.scene.vanilla import VanillaScene, VanillaSceneConfig
    scenes = {VanillaSceneConfig: VanillaScene,
              TwoDGSSceneConfig: TwoDGSScene,
              PGSRSceneConfig: PGSRScene,
              ScaffoldSceneConfig: ScaffoldScene,
              OctreeSceneConfig: OctreeScene,
              Scaffold2DGSSceneConfig: Scaffold2DGSScene,
              Octree2DGSSceneConfig: Octree2DGSScene,
              ScaffoldPGSRSceneConfig: ScaffoldPGSRScene,
              OctreePGSRSceneConfig: OctreePGSRScene}
    cls = scenes.get(type(config.scene))
    if cls is None:
        raise NotImplementedError(
            f"no ported scene for {type(config.scene).__name__}")
    return cls(config.scene, config.source_path, device, eval=config.eval,
               seed=config.machine.seed, **kwargs)


def config_classes():
    """Name -> class map for YAML round trips."""
    from gssr_tpu_torch.models.octree import OctreeGaussianConfig
    from gssr_tpu_torch.models.pgsr import PGSRGaussianConfig
    from gssr_tpu_torch.models.scaffold import ScaffoldGaussianConfig
    from gssr_tpu_torch.models.twod import TwoDGaussianConfig
    from gssr_tpu_torch.models.vanilla import VanillaGaussianConfig
    from gssr_tpu_torch.scene.octree import OctreeSceneConfig
    from gssr_tpu_torch.scene.octree_2dgs import Octree2DGSSceneConfig
    from gssr_tpu_torch.scene.octree_pgsr import OctreePGSRSceneConfig
    from gssr_tpu_torch.scene.pgsr import PGSRSceneConfig
    from gssr_tpu_torch.scene.scaffold import ScaffoldSceneConfig
    from gssr_tpu_torch.scene.scaffold_2dgs import Scaffold2DGSSceneConfig
    from gssr_tpu_torch.scene.scaffold_pgsr import ScaffoldPGSRSceneConfig
    from gssr_tpu_torch.scene.twodgs import TwoDGSSceneConfig
    from gssr_tpu_torch.scene.vanilla import VanillaSceneConfig
    classes = [Config, MachineConfig, TrainerConfig, DataLoaderConfig,
               PartitionConfig,
               VanillaGaussianConfig, VanillaSceneConfig,
               TwoDGaussianConfig, TwoDGSSceneConfig, PGSRGaussianConfig,
               PGSRSceneConfig, ScaffoldGaussianConfig, ScaffoldSceneConfig,
               OctreeGaussianConfig, OctreeSceneConfig,
               Scaffold2DGSSceneConfig, Octree2DGSSceneConfig,
               ScaffoldPGSRSceneConfig, OctreePGSRSceneConfig]
    return {c.__name__: c for c in classes}
