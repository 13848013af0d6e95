"""Hardware-free smoke test of the port: the untargeted digital one-pixel
DE attack on the committed sample image with ResNet-18 (counterpart of
the root ``test_digital_one_pixel_attack.py``, reference
``test_digital_one_pixel_attack.py``).

Block 41 pixels, 10 generations, population 50; the population is
perturbed and classified as one batch per generation on the card.

Usage:
  python -m spaa_tpu_torch.digital_one_pixel_attack [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from os.path import dirname, join

_REPO = dirname(dirname(os.path.abspath(__file__)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--weights-dir", default=join(_REPO, "checkpoint"),
                    help="where the pinned classifier .pth files are")
    args = ap.parse_args(argv)

    import torch

    from spaa_tpu_torch.attack.one_pixel import DigitalOnePixelAttacker
    from spaa_tpu_torch.models.classifiers import (Classifier,
                                                   load_imagenet_labels)
    from spaa_tpu_torch.utils.io import imread

    imagenet_labels = load_imagenet_labels(
        join(_REPO, "data/imagenet1000_clsidx_to_labels.txt"))
    classifier = Classifier("resnet18", weights_dir=args.weights_dir,
                            device=args.device)
    im = torch.from_numpy(imread(join(_REPO, "data/sample/sample.png"))).to(
        classifier.device)
    _, p, idx = classifier(im[None], (224, 224))
    true_idx = int(idx[0, 0])
    print(f"clean prediction: {imagenet_labels[true_idx]} (p={p[0, 0]:.2f})")

    attacker = DigitalOnePixelAttacker(imagenet_labels, (224, 224))
    t0 = time.time()
    table, _ = attacker(im, classifier, targeted_attack=False,
                        target_idx=true_idx, pixel_count=1, pixel_size=41,
                        maxiter=10, popsize=50, verbose=True)
    if classifier.device.type == "cuda":
        torch.cuda.synchronize()
    print(table.to_string())
    print(f"attack {time.time() - t0:.3f} s on {classifier.device}, "
          f"cache misses {attacker.cache_misses}")


if __name__ == "__main__":
    main()
