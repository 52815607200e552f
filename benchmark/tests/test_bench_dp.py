"""The data-parallel driver (``drivers/train_dp.py``) rehearsed on the CPU
in four gloo processes at tiny sizes, two rows a rank, as the cell
``list.train.dp4`` runs it (``conftest.DP4``: a cell that BENCHMARK.json
does not list yet, PERF.md §7).  A run prints a correct line of the
contract's shape with every rank's parameters equal to rank 0's, and a
traced run states no device time.  Its faults: ``test_bench_control.py``."""

from conftest import DP4, rehearse


def test_four_ranks_train_correctly():
    line, err, _ = rehearse(DP4['name'])
    assert list(line)[-1] == 'checks'
    assert line['correct'], err
    assert set(line['metrics']) == {'train_step_s', 'setup_s'}
    assert line['attempted'] > 0 and line['failed'] == 0
    assert line['checks']['rank_gap']['value'] == 0.0


def test_four_ranks_traced_state_no_device_time():
    line, err, _ = rehearse(DP4['name'], trace=True)
    assert line['correct'], err
    # host clock only: the step's batch; no device span, trace or peak
    assert set(line['metrics']) == {'batch_ms'}, line['metrics']
