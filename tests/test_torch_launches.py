"""chip_smoke.py's launch table on the CPU: the launches each path of the
port must give on the card, worked out from the encoder's layers, the
BatchNorm routing rule and the decode's plan, held to the counts the
kernels' paths give today; none on the CPU."""

import pytest

import chip_smoke
from list_tpu_torch.ops.cuda import launch_counts


def counts(k2=0, dx=0, dk=0, k1=0, k4=0, bn=0, bn_bwd=0, percep=0, vox=0):
    return dict(conv3x3x3=k2, conv3x3x3_dx=dx, conv3x3x3_dk=dk,
                fused_stack_head=k1, fused_fc0_mlp=k4, batch_norm=bn,
                batch_norm_bwd=bn_bwd, percep_sample=percep, voxel_taps=vox)


step = chip_smoke.step_launches
decode = chip_smoke.decode_launches

# (path, the table's launches, the launches the path gives): a stage-2 step
# runs the encoder's 5 full-resolution convolutions forward (twice under
# remat), dx of 4 and dk of 5; bn_0, bn_1, bn_3 and bn_4 take the BatchNorm
# kernels at 128^3 at any batch, and the training forward of the one-channel
# bn_0 and bn_1; a dense decode launches one head and one perceptual sample
# a slab, and voxel_taps once a kept group a slab (3 groups: 128^3 x 17,
# 64^3 x 32, 32^3 x 64; under --use_pallas 1 a scale: 4) and once for the
# coarse term (16^3 and 8^3), hoisted at R <= 128 (once a card), else a
# slab
CASES = [
    ('remat step, batch 8, 128^3', step(),
     counts(k2=14, dx=4, dk=5, bn=4, bn_bwd=4)),
    ('step without remat', step(remat=False),
     counts(k2=9, dx=4, dk=5, bn=2, bn_bwd=4)),
    ('step under a process group', step(batch=4, group=True),
     counts(k2=14, dx=4, dk=5)),
    ('step at batch 2, 32^3: no BatchNorm routed', step(batch=2, R=32),
     counts(k2=14, dx=4, dk=5)),
    ('128^3 request', decode(encodes=(1,)),
     counts(k2=5, k1=1, bn=4, percep=1, vox=4)),
    ('256^3 decode in slabs of 8', decode(R=256, slab=8),
     counts(k1=32, percep=32, vox=128)),
    ('128^3 decode under --use_pallas 1', decode(slab=64, head=1),
     counts(k4=2, percep=2, vox=9)),
    ('128^3 decode by the plain head', decode(slab=64, head=0),
     counts(percep=2, vox=7)),
    ('128^3 decode split over 2 cards in slabs of 32',
     decode(slab=32, cards=2), counts(k1=4, percep=4, vox=14)),
    ('4 meshes of --infer_batch 2 in 3 encodes',
     decode(meshes=4, encodes=(1, 2, 1)),
     counts(k2=15, k1=4, bn=12, percep=4, vox=16)),
    ('chunked decoder', decode(slab=None, head=0), counts()),
    ('step on the CPU', step(False), counts()),
    ('request on the CPU', decode(False, encodes=(1,)), counts()),
]


@pytest.mark.parametrize('got,want', [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_launch_table(got, want):
    assert got == want


def test_launch_table_has_every_counter():
    """The table names the counters ``launch_counts()`` keeps, and no
    other."""
    assert list(chip_smoke.launches()) == list(launch_counts())
    with pytest.raises(KeyError, match='no launch counter'):
        chip_smoke.launches(conv3x3x3_dw=1)
