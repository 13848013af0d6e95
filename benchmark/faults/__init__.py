"""Faults planted in the program under test, to see that the check reads
them as not correct (``benchmark/tests/test_harness_faults.py`` on the CPU,
``python3 -m benchmark.control`` on the card). Never used by a run of the
benchmark itself.

- ``unchanged``: a step that returns its state unchanged;
- ``half_batch``: half of the batch left out (the second half keeps its
  state, or the mean is taken over the first half);
- ``answer_altered``: an answer altered where it is produced.

Each traffic's driver finds its faults by its name, as it finds its
driver: ``faults/<driver>.py`` has ``plant(fault)``, a context manager
that plants ``fault`` in the program that driver runs. A cell on one chip
has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import importlib
from os.path import dirname, exists, join

FAULTS = ("unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def patched(module: str, name: str, make):
    """``module.name`` replaced by ``make(original)`` inside the block."""
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def planted(driver: str, fault: str):
    """Context manager: ``fault`` planted in the program that driver
    ``driver`` (a traffic's ``"driver"``) runs."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if not exists(join(dirname(__file__), driver + ".py")):
        raise FileNotFoundError(
            f"no faults for driver {driver!r}: benchmark/faults/{driver}.py "
            "is missing")
    return importlib.import_module(f"benchmark.faults.{driver}").plant(fault)
