"""A model plugs in through new files only.  A toy model that no source of
the benchmark names comes with what a model's PR brings: its model and
executor classes, their entry in the program's registry, its reference
module, a configuration, limits and BENCHMARK.json entries.  It runs a
training cell through ``harness.run_cell`` on the CPU, comes out correct,
and no file of the benchmark changes."""

import hashlib
import importlib
import json
import os
import shutil
import sys

from benchmark import harness

MODELS = '''
import torch


class Toy(torch.nn.Module):
    """Two linear layers over an image's mean colour."""

    def __init__(self, hidden=16):
        super().__init__()
        self.fc_0 = torch.nn.Linear(3, hidden)
        self.fc_1 = torch.nn.Linear(hidden, 1)

    @classmethod
    def from_config(cls, config):
        return cls()

    def forward(self, img):
        h = torch.relu(self.fc_0(img.mean(dim=(1, 2))))
        return self.fc_1(h)[:, 0]
'''

EXECUTORS = '''
import torch


class Toy:
    """The executor contract of a training cell: ``train(batch)``,
    ``model``, ``optimizer``."""

    def __init__(self, config, model, device=None):
        self.model = model.to(device)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=config.lr,
            betas=(config.beta1, 0.999), weight_decay=config.weight_decay)

    def train(self, batch):
        x = {k: torch.as_tensor(v) for k, v in batch.items()}
        self.optimizer.zero_grad(set_to_none=True)
        loss = ((self.model(x['rgb_image']) - x['target']) ** 2).mean()
        loss.backward()
        self.optimizer.step()
        return None, {'mse': loss.detach()}
'''

REFERENCE = '''
import torch
import torch.nn.functional as F


def spec(cfg):
    h = cfg['h_dim']
    return [('fc_0.weight', (h, 3), 'w', 3 ** -0.5),
            ('fc_0.bias', (h,), 'zero', 0.0),
            ('fc_1.weight', (1, h), 'w', h ** -0.5),
            ('fc_1.bias', (1,), 'zero', 0.0)]


def batches(cfg, traffic, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    B = cfg['train_batch_size']
    return [{'rgb_image': torch.rand(B, 8, 8, 3, generator=g).numpy(),
             'target': torch.rand(B, generator=g).numpy()}
            for _ in range(traffic['distinct_batches'])]


def losses(P, cfg, batch, chunk, low=False):
    x = batch['rgb_image'].mean(dim=(1, 2))
    h = F.relu(F.linear(x, P['fc_0.weight'], P['fc_0.bias']))
    pred = F.linear(h, P['fc_1.weight'], P['fc_1.bias'])[:, 0]
    loss = ((pred - batch['target']) ** 2).mean()
    loss.backward()
    return {'mse': loss.detach()}


def train_step_flops(cfg):
    return 3 * cfg['train_batch_size'] * 2 * 4 * cfg['h_dim']
'''

FLAGS = dict(train_batch_size=4, lr=1e-3, beta1=0.9, weight_decay=1e-5)


def _bench():
    b = harness.bench()
    e2e = [dict(m, workloads=['toy.train']) if m['name'] == 'train_step_s'
           else m for m in b['end_to_end']
           if m['name'] in ('train_step_s', 'setup_s')]
    mfu = harness.find(b['per_layer'], 'train_mfu_pct', 'metric')
    return dict(b, configs=[dict(
        name='toy', source='a test', file='benchmark/configs/toy.json',
        reduced=[], why='a toy model')], workloads=[dict(
            name='toy.train', config='toy', traffic='train_closed', chips=1,
            why='a test cell')], end_to_end=e2e,
        per_layer=[dict(mfu, workloads=['toy.train'])])


def _digest(root):
    out = {}
    for d, _, fs in os.walk(os.path.join(root, 'benchmark')):
        for f in fs:
            if f.endswith(('.py', '.json')) and '__pycache__' not in d:
                p = os.path.join(d, f)
                out[p] = hashlib.sha256(open(p, 'rb').read()).hexdigest()
    return out


def test_a_model_plugs_in_through_new_files_only(tmp_path, monkeypatch):
    from list_tpu_torch import registry
    pkg = tmp_path / 'benchtoy'
    pkg.mkdir()
    (pkg / '__init__.py').write_text('')
    (pkg / 'models.py').write_text(MODELS)
    (pkg / 'executors.py').write_text(EXECUTORS)
    (pkg / 'reference.py').write_text(REFERENCE)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setitem(registry._ALIASES, 'Toy', 'benchtoy.models.Toy')
    monkeypatch.setitem(sys.modules, 'benchmark.reference.models.Toy',
                        importlib.import_module('benchtoy.reference'))

    root = tmp_path / 'root'
    data = root / 'benchmark'
    for sub in ('configs', 'limits', 'traffic'):
        (data / sub).mkdir(parents=True)
    (root / 'BENCHMARK.json').write_text(json.dumps(_bench()))
    (data / 'configs' / 'toy.json').write_text(json.dumps(
        dict(FLAGS, model='Toy', h_dim=16, program_flags=FLAGS)))
    (data / 'limits' / 'toy.train.json').write_text(json.dumps(
        {'loss_gap_first': 1e-5, 'grad_gap': 1e-4, 'step_gap': 1e-3}))
    shutil.copy(os.path.join(harness.HERE, 'traffic', 'train_closed.json'),
                data / 'traffic')

    before = _digest(harness.ROOT)
    line, err, _ = harness.run_cell('toy.train', 2 ** 31 + 3, 0.5, False,
                                    'cpu', root=str(root))
    assert line['correct'], err
    assert line['attempted'] > 0
    assert set(line['metrics']) == {'train_step_s', 'setup_s'}
    assert set(line['checks']) == {'loss_gap_first', 'grad_gap', 'step_gap'}
    assert _digest(harness.ROOT) == before
