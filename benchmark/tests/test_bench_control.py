"""The comparison against the faults a cell can have and against its
control, driven through the rest of a run at tiny sizes on the CPU (a
cell over several ranks in as many gloo processes): each fault comes out
not correct, and the mesh control reads far above the program.  The
control of a training cell is the reference in TF32, which only a card
computes; it runs where there is one."""

import pytest

from conftest import rehearse

FAULTS = [('list.train', 'fault_unchanged'),
          ('list.train', 'fault_half_batch'),
          ('coarsenet.train', 'fault_unchanged'),
          ('coarsenet.train', 'fault_half_batch'),
          ('list.mesh128', 'fault_swap'),
          ('list.train.dp4', 'fault_unchanged'),
          ('list.train.dp4', 'fault_half_batch'),
          ('list.train.dp4', 'fault_no_exchange')]


@pytest.mark.parametrize('cell,fault', FAULTS)
def test_a_fault_comes_out_not_correct(cell, fault):
    line, err, _ = rehearse(cell, mode=fault)
    assert not line['correct'], err


def test_the_mesh_control_reads_far_above_the_program():
    """The fp8 decoder of the control against the program on one seed at
    the tiny size: each number reads 5x or more the program's.  (The
    cell's limits were set at its own size, where the control's lowest
    readings of the numbers compared are 6.4x and 6.6x the program's
    highest.)"""
    _, _, prog = rehearse('list.mesh128', mode='program')
    _, _, ctl = rehearse('list.mesh128', mode='control')
    for k, v in prog.items():
        assert ctl[k] >= 5 * v, (k, ctl[k], v)


@pytest.mark.parametrize('cell', ['list.train', 'coarsenet.train'])
def test_the_training_control_comes_out_not_correct_on_a_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('TF32 needs a CUDA card')
    line, err, _ = rehearse(cell, 2 ** 31 + 11, 0, mode='control',
                            device='cuda')
    assert not line['correct'], err


test_the_training_control_comes_out_not_correct_on_a_card = pytest.mark.cuda(
    test_the_training_control_comes_out_not_correct_on_a_card)
