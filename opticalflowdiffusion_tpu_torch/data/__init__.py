"""Datasets (JAX ``data/``): the procedural artificial dataset, the
constant-velocity video dataset and the Sintel, FlyingChairs, KITTI and
TaiChi readers, by name."""

from .loader import DataLoader  # noqa: F401

DATASETS = ("artificial", "sintel", "flying_chairs", "kitti_single", "artificial_video",
            "taichi")


def get_dataset(name: str):
    """The dataset class of ``name`` (``DATASETS``)."""
    if name == "artificial":
        from .artificial import ArtificialDataset as D
    elif name == "sintel":
        from .sintel import SintelDataset as D
    elif name == "flying_chairs":
        from .flying_chairs import FlyingChairsDataset as D
    elif name == "kitti_single":
        from .kitti_single import KittiSingleDataset as D
    elif name == "artificial_video":
        from .artificial_video import ArtificialVideoDataset as D
    elif name == "taichi":
        from .taichi import TaiChiDataset as D
    else:
        raise KeyError(f"unknown dataset {name!r}; known: {DATASETS}")
    return D


__all__ = ["DATASETS", "DataLoader", "get_dataset"]
