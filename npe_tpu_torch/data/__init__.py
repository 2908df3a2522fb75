from npe_tpu_torch.data.datasets import (  # noqa: F401
    CompositePhotos64,
    Hdf5ImageDataset,
    NpzImageDataset,
    RealPhotos64,
    SyntheticFaces,
    data_loader,
    get_dataset,
    index_loader,
)
