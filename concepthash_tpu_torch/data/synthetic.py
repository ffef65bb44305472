"""Synthetic dataset generator in the reference's manifest format (the port's
own copy of concepthash_tpu/data/synthetic.py: the same images for the same
seed): k classes of procedurally distinct images, written as PNG files with
train/test/database manifests and class_names.txt, so the whole decode ->
augment -> train -> retrieve path runs end to end in seconds.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def make_synthetic_dataset(root: str, nclass: int = 3, per_class_train: int = 8,
                           per_class_test: int = 4, image_size: int = 64,
                           seed: int = 0, db_equals_train: bool = True) -> str:
    """Creates <root>/{images/, train.txt, test.txt, database.txt,
    class_names.txt}. Class appearance = distinct base color + frequency
    pattern + noise. Returns root. The images are drawn in order from one
    generator; up to 8 threads encode the PNGs (zlib runs outside the
    GIL), a few dozen images in flight at most."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    from PIL import Image

    base_colors = rng.integers(40, 216, (nclass, 3))
    freqs = rng.uniform(1.0, 4.0, (nclass, 2))
    yy, xx = np.meshgrid(np.linspace(0, 1, image_size),
                         np.linspace(0, 1, image_size), indexing="ij")
    looks = {}

    def render(cls: int, r: np.random.Generator) -> np.ndarray:
        if cls not in looks:
            pattern = 0.5 + 0.5 * np.sin(2 * np.pi * (freqs[cls, 0] * yy +
                                                      freqs[cls, 1] * xx))
            looks[cls] = (base_colors[cls][None, None, :]
                          * (0.6 + 0.4 * pattern[..., None]))
        img = looks[cls] + r.normal(0, 12, looks[cls].shape)
        return np.clip(img, 0, 255).astype(np.uint8)

    workers = min(8, os.cpu_count() or 1)
    pending: collections.deque = collections.deque()

    def write_split(name: str, per_class: int) -> list:
        lines = []
        for c in range(nclass):
            for j in range(per_class):
                fn = f"images/{name}_c{c}_{j}.png"
                pending.append(pool.submit(Image.fromarray(render(c, rng)).save,
                                           os.path.join(root, fn)))
                if len(pending) > 4 * workers:
                    pending.popleft().result()
                lines.append(f"{fn} {c}")
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        return lines

    with ThreadPoolExecutor(workers) as pool:
        train_lines = write_split("train", per_class_train)
        write_split("test", per_class_test)
        if db_equals_train:
            with open(os.path.join(root, "database.txt"), "w") as f:
                f.write("\n".join(train_lines) + "\n")
        else:
            write_split("database", per_class_train)
        while pending:
            pending.popleft().result()

    with open(os.path.join(root, "class_names.txt"), "w") as f:
        f.write("\n".join(f"synthetic_class_{c}" for c in range(nclass)) + "\n")
    return root
