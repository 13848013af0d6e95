#!/usr/bin/env python3
"""``tools/torch_profile_sweep.py`` with another classifier, on one GPU.

    python3 tools/torch_profile_classifier.py vgg16 [--iters 3]
    python3 tools/torch_profile_classifier.py inception_v3

Runs the same breakdown (iteration time, each layer alone, kernel view
and idle share) of the full-width SPAA iteration, with VGG-16 (224x224)
or Inception-v3 (299x299) in place of ResNet-18; their weights are the
seeded init unless the pinned torchvision ``.pth`` is in ``checkpoint/``.
Any further argument goes to ``torch_profile_sweep.py``.
"""

import sys
from os.path import abspath, dirname

sys.path.insert(0, dirname(abspath(__file__)))
sys.path.insert(0, dirname(dirname(abspath(__file__))))


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in ("resnet18", "vgg16",
                                                "inception_v3"):
        raise SystemExit(__doc__)
    name = sys.argv.pop(1)

    import torch_profile_sweep
    from spaa_tpu_torch.models import classifiers

    zoo_classifier = classifiers.Classifier

    def classifier(_model_name, *args, **kwargs):
        return zoo_classifier(name, *args, **kwargs)

    classifiers.Classifier = classifier     # what the sweep tool builds
    print(f"[profile] classifier: {name}")
    torch_profile_sweep.main()


if __name__ == "__main__":
    main()
