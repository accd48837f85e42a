"""The port's straggler monitor (``repro_torch.runtime.straggler``) against
the reference's (``repro.runtime.straggler``), which is host code and runs
here: the same seeded per-host step-time sequences go through both, and the
flags, strikes, swaps and EWMAs must be equal after every step, through
``replace_host`` and at odd and even fleet sizes (the true median)."""
import numpy as np
import pytest

from repro.runtime import straggler as ref
from repro_torch.runtime import straggler as port
from repro_torch.telemetry import get_registry


def _times(rng, hosts, slow):
    """One step's wall times: lognormal around 1 s, ``slow`` hosts 2-4x."""
    t = {h: float(np.exp(rng.normal(0.0, 0.05))) for h in hosts}
    for h in slow:
        t[h] *= float(rng.uniform(2.0, 4.0))
    return t


def _same(a, b):
    assert a.swaps == b.swaps
    assert sorted(a.hosts) == sorted(b.hosts)
    for h in a.hosts:
        sa, sb = a.hosts[h], b.hosts[h]
        assert (sa.ewma_time, sa.strikes, sa.flagged) == \
            (sb.ewma_time, sb.strikes, sb.flagged), h


@pytest.mark.parametrize("n_hosts", [2, 3, 4, 7, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_monitor_matches_reference(n_hosts, seed):
    rng = np.random.default_rng(seed)
    cfg = dict(threshold=1.4, patience=2, ewma=0.6)
    a = ref.StragglerMonitor(ref.StragglerConfig(**cfg))
    b = port.StragglerMonitor(port.StragglerConfig(**cfg))
    hosts = list(range(n_hosts))
    slow = {n_hosts - 1}
    for step in range(24):
        if step == 8:  # the straggler is swapped out for a healthy host
            for m in (a, b):
                m.replace_host(n_hosts - 1)
            slow = set()
        if step == 16 and n_hosts > 2:  # a second host turns slow
            slow = {0}
        t = _times(rng, hosts, slow)
        assert a.record_step(dict(t)) == b.record_step(dict(t)), step
        _same(a, b)
    assert b.swaps, "a persistent straggler must be flagged"
    for h in hosts:
        g = get_registry().gauge(f"straggler.ewma_s.host{h}").value
        assert g == b.hosts[h].ewma_time


def test_median_is_the_true_median():
    for n in range(1, 9):
        vals = list(np.random.default_rng(n).uniform(0, 1, n))
        assert port._median(vals) == ref._median(vals) == \
            float(np.median(vals))


def test_replace_host_drops_the_entry():
    b = port.StragglerMonitor()
    for _ in range(5):
        b.record_step({0: 1.0, 1: 1.0, 2: 5.0})
    assert b.swaps == [2] and b.hosts[2].flagged
    b.replace_host(2)
    assert 2 not in b.hosts
    assert get_registry().gauge("straggler.ewma_s.host2").value == 0.0
    b.record_step({0: 1.0, 1: 1.0, 2: 1.2})
    assert b.hosts[2].ewma_time == 1.2, "re-seeded from its first sample"
