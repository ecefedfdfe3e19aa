"""One intra-op thread a torch process while a port test runs.

The tier-1 suite runs several pytest workers on one host, and torch
gives every process as many intra-op threads as the host has cores: the
workers, and the gloo ranks, `train_lm` and `serve_lm` children the
port's tests start, oversubscribe the cores many times over (on an
8-core host the seed tree's suite took 906 s under 6 workers with
torch's default and 552 s with one thread a process, the same tests
passing). Every port test module imports the autouse fixture below: the
test runs on one torch thread, and the processes it starts inherit
OMP_NUM_THREADS=1.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    yield
    torch.set_num_threads(threads)
