"""``correct`` at a size a CPU test can hold: every cell reads correct
on the port, and not correct with the control (the reference in the
program's place, the synapse product in TF32 and plasticity in bfloat16)
or with a fault planted in the timed path: a call that returns its state
unchanged, half the batch left out, the exchange between chips left
out, an answer altered where it is produced.  The harness's look for a
card is skipped; the rest of a run is the benchmark's own."""

import pytest
from torch_threads import share_cores

from bench.control import run_control
from bench.tests import faults, tiny

share_cores()


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_port_reads_correct(cell):
    line = tiny.run(cell)
    assert line["correct"], line["check"]
    assert line["attempted"] == 3 or "engine" in cell
    assert list(line)[-1] == "check"


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_control_reads_not_correct(cell):
    line = run_control(*tiny.context(cell))
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_planted_fault_reads_not_correct(cell, fault):
    with faults.FAULTS[fault]():
        line = tiny.run(cell)
    assert not line["correct"], line["check"]
