"""The control on the card: the plain reference in the program's place, in
TF32 (the configurations state float32 with TF32 off), has to come out as
not correct, and the program as correct, at the published widths with a
short sweep. ``python3 -m benchmark.control`` reads the same at the cells'
own sizes."""

import pytest

from benchmark import harness as H
from benchmark.run import _fails

SMALL = {"sweep132x50": {"d_threshes": [5], "targets_per_config": 3,
                         "iters": 8, "check_steps": 4},
         "pcnet-train-b24": {},
         "percal11x50": {"iters": 8, "check_steps": 4}}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["resnet18-attack", "vgg16-attack",
                                      "pcnet-train", "resnet18-percal"])
@pytest.mark.parametrize("mode", ["program", "control"])
def test_control_is_not_correct(cuda, workload, mode, queued_cells):
    _, _, config, traffic, limits = H.cell_files(workload)
    traffic.update(SMALL[traffic["name"]])
    drv = H.driver_class(traffic)(config, traffic, 2 ** 31 + 31, cuda,
                                  mode=mode)
    drv.setup()
    drv.window(None, drv.check_iters())
    drv.free_program()
    checks = drv.check(limits)
    assert any(_fails(c) for c in checks) == (mode == "control"), checks
