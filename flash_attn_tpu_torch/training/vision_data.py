"""Image-classification data (counterpart of
`flash_attn_tpu/training/vision_data.py`: `synthetic_images:37`,
`_load_array_source:50`, `_load_image_folder:59`, `ImageDataset:83`,
`VisionLoader:93`, `make_image_loader:129`, `augment_batch:154`).

The host only indexes and stacks uint8 (N, H, W, 3) arrays (plain numpy, as
in JAX, so the batches are bit-identical for the same seed); augmentation
runs on the device in the training step.  JAX draws the crop offsets and
flips with `jax.random` keyed by (seed, step); here `augment_draws` draws
the same kinds of values from a `torch.Generator` seeded by (seed, step),
and `augment_batch` is a function of those draws, so the transform can be
held against JAX's at given draws.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from flash_attn_tpu_torch.training.data import LoaderState

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def synthetic_images(num: int, image_size: int, num_classes: int,
                     seed: int = 0):
    """Class-conditional noisy colour fields: (num, s, s, 3) uint8 images
    and (num,) int32 labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num).astype(np.int32)
    base = rng.uniform(64, 192, (num_classes, 1, 1, 3))
    imgs = base[labels] + rng.normal(0, 24, (num, image_size, image_size, 3))
    return np.clip(imgs, 0, 255).astype(np.uint8), labels


def _load_array_source(path: Path):
    if path.suffix == ".npz":
        z = np.load(path)
        return np.asarray(z["images"]), np.asarray(z["labels"], np.int32)
    return (np.load(path / "images.npy"),
            np.asarray(np.load(path / "labels.npy"), np.int32))


def _load_image_folder(root: Path, image_size: int):
    """ImageFolder layout (one subdirectory of images per class), decoded
    once with PIL into a uint8 array."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "image-folder datasets need PIL; preprocess to .npz instead"
        ) from e
    classes = sorted(p.name for p in root.iterdir() if p.is_dir())
    imgs, labels = [], []
    for ci, cname in enumerate(classes):
        for f in sorted((root / cname).iterdir()):
            if f.suffix.lower() not in (".jpg", ".jpeg", ".png", ".bmp"):
                continue
            im = Image.open(f).convert("RGB").resize((image_size, image_size))
            imgs.append(np.asarray(im, np.uint8))
            labels.append(ci)
    return np.stack(imgs), np.asarray(labels, np.int32)


class ImageDataset:
    def __init__(self, images: np.ndarray, labels: np.ndarray):
        if images.ndim != 4 or images.shape[0] != labels.shape[0]:
            raise ValueError(f"images {images.shape}, labels {labels.shape}")
        self.images = images
        self.labels = labels

    def __len__(self):
        return self.images.shape[0]


class VisionLoader:
    """Deterministic, resumable (images, labels) numpy batches: the
    epoch's permutation is a function of (seed, epoch) and the state keeps
    the position inside the epoch, as in `FaultTolerantLoader`."""

    def __init__(self, dataset: ImageDataset, batch_size: int, seed: int = 0,
                 state: Optional[LoaderState] = None, shuffle: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.state = state or LoaderState(seed=seed)
        self.batches_per_epoch = max(1, len(dataset) // batch_size)

    def _epoch_perm(self, epoch):
        if not self.shuffle:
            return np.arange(len(self.dataset))
        rng = np.random.default_rng((self.state.seed, epoch))
        return rng.permutation(len(self.dataset))

    def __iter__(self):
        return self

    def __next__(self):
        st = self.state
        if st.batches_served >= self.batches_per_epoch:
            st.epoch += 1
            st.batches_served = 0
        perm = self._epoch_perm(st.epoch)
        i0 = st.batches_served * self.batch_size
        idx = perm[i0:i0 + self.batch_size]
        if len(idx) < self.batch_size:  # a dataset smaller than a batch
            idx = np.resize(idx, self.batch_size)
        st.batches_served += 1
        return self.dataset.images[idx], self.dataset.labels[idx]


def make_image_loader(data_cfg, num_classes: int) -> VisionLoader:
    """The loader of a DataConfig: dataset "synthetic" (`max_examples`
    images, 512 by default), an .npz / array-directory shard, or an
    ImageFolder tree."""
    size = int(getattr(data_cfg, "image_size", 224) or 224)
    name = data_cfg.dataset
    if name in (None, "", "synthetic"):
        images, labels = synthetic_images(data_cfg.max_examples or 512, size,
                                          num_classes, seed=data_cfg.seed)
    else:
        path = Path(name)
        if path.suffix == ".npz" or (path / "images.npy").exists():
            images, labels = _load_array_source(path)
        else:
            images, labels = _load_image_folder(path, size)
        if data_cfg.max_examples:
            images = images[: data_cfg.max_examples]
            labels = labels[: data_cfg.max_examples]
    return VisionLoader(ImageDataset(images, labels), data_cfg.batch_size,
                        seed=data_cfg.seed)


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded by (seed, step): the role of JAX's
    `fold_in(PRNGKey(seed), step)`."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def augment_draws(b: int, generator: torch.Generator, pad: int = 4):
    """(oy, ox, flip): per-image crop offsets in [0, 2 pad] and horizontal
    flips with probability 1/2, drawn on the CPU from `generator`."""
    oy = torch.randint(0, 2 * pad + 1, (b,), generator=generator)
    ox = torch.randint(0, 2 * pad + 1, (b,), generator=generator)
    flip = torch.rand(b, generator=generator) < 0.5
    return oy, ox, flip


def augment_batch(images, draws=None, *, train: bool, pad: int = 4):
    """Augmentation and normalisation on the images' device (`:154`).

    images: (b, h, w, 3) uint8.  Normalised with the ImageNet mean and
    deviation; with `train`, reflect-padded by `pad`, cropped back at the
    draws' offsets and flipped where they say.  Returns float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    x = (images.float() / 255.0 - mean) / std
    if not train:
        return x
    b, h, w, _ = x.shape
    oy, ox, flip = (t.to(images.device) for t in draws)
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (pad,) * 4,
                                 mode="reflect").permute(0, 2, 3, 1)
    rows = oy[:, None] + torch.arange(h, device=x.device)[None, :]
    cols = ox[:, None] + torch.arange(w, device=x.device)[None, :]
    flipped = torch.where(flip[:, None], cols.flip(-1), cols)
    bidx = torch.arange(b, device=x.device)[:, None, None]
    return xp[bidx, rows[:, :, None], flipped[:, None, :]]
