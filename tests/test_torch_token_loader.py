"""The port's token loader (skypilot_tpu_torch/data/token_loader.py):
the native route over the reference's native/token_loader.cpp, built
by the port into build/native/, against the numpy routes, CPU:

  - sequential windows: the native route's batches equal the port's
    numpy route and the reference's numpy TokenLoader byte for byte, in
    step order (the core's workers may finish steps out of order), over
    shard boundaries and for every rank of a world of 3;
  - shuffled windows: the native route's batches equal a plain numpy
    rendering of the core's splitmix64 window draw;
  - the build leaves the tracked native/ files as they are, and a
    missing compiler is reported, not hidden;
  - train_lm --data reads through the native reader and says so.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from skypilot_tpu.data.token_loader import TokenLoader as JaxTokenLoader
from skypilot_tpu_torch.data import token_loader
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp('tokens')
    paths, offset = [], 0
    for i, n in enumerate((700, 1300, 450)):
        arr = (np.arange(offset, offset + n) * 7 % 50257).astype(np.uint16)
        p = d / f'shard{i}.bin'
        arr.tofile(p)
        paths.append(str(p))
        offset += n
    return paths


@pytest.fixture(scope='module')
def native():
    reason = token_loader.native_unavailable_reason()
    assert reason is None, reason      # this box has g++
    return True


@pytest.mark.parametrize('batch,seq,rank,world', [(3, 64, 0, 1),
                                                  (4, 33, 2, 3),
                                                  (1, 600, 1, 2)])
def test_native_equals_the_numpy_routes_sequentially(shards, native, batch,
                                                     seq, rank, world):
    kw = dict(batch=batch, seq=seq, seed=5, rank=rank, world=world,
              shuffle=False)
    fast = token_loader.TokenLoader(shards, prefetch_threads=3, **kw)
    plain = token_loader.TokenLoader(shards, use_native=False, **kw)
    ref = JaxTokenLoader(shards, use_native=False, **kw)
    assert fast.native and not plain.native
    assert fast.total_tokens == plain.total_tokens == 2450
    try:
        for _ in range(40):
            got = fast.next_batch()
            assert got.dtype == np.uint32 and got.shape == (batch, seq + 1)
            want = plain.next_batch()
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(want, ref.next_batch())
    finally:
        fast.close()


def _splitmix64(x):
    x = (x + np.uint64(0x9e3779b97f4a7c15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xbf58476d1ce4e5b9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94d049bb133111eb)
    return x ^ (x >> np.uint64(31))


def _shuffled_plain(tokens, batch, seq, seed, rank, step):
    """The core's shuffled window draw, in numpy uint64 arithmetic."""
    out = np.empty((batch, seq + 1), np.uint32)
    with np.errstate(over='ignore'):
        for b in range(batch):
            key = _splitmix64(np.uint64(seed) ^ np.uint64(step * 0x10001)
                              ^ np.uint64(rank << 40) ^ np.uint64(b))
            start = int(key % np.uint64(len(tokens) - seq - 1))
            out[b] = tokens[start:start + seq + 1]
    return out


def test_native_shuffle_is_the_cores_splitmix_draw(shards, native):
    tokens = np.concatenate([np.fromfile(p, np.uint16) for p in shards])
    loader = token_loader.TokenLoader(shards, batch=4, seq=48, seed=11,
                                      rank=1, world=2)
    try:
        for step in range(25):
            np.testing.assert_array_equal(
                loader.next_batch(),
                _shuffled_plain(tokens, 4, 48, 11, 1, step))
    finally:
        loader.close()


def test_build_leaves_tracked_files_and_reports_failures(native, tmp_path,
                                                         monkeypatch):
    assert token_loader._lib_path().exists()
    assert token_loader._lib_path().parent == ROOT / 'build' / 'native'
    status = subprocess.run(['git', 'status', '--porcelain', 'native/'],
                            cwd=ROOT, capture_output=True, text=True,
                            check=True)
    assert status.stdout == ''
    monkeypatch.setenv('CXX', '/bin/false')
    with pytest.raises(OSError, match='failed'):
        token_loader._build(tmp_path / 'lib.so')
    assert not (tmp_path / 'lib.so').exists()


def test_too_small_dataset_is_refused_by_both_routes(tmp_path, native):
    p = tmp_path / 'tiny.bin'
    np.arange(10, dtype=np.uint16).tofile(p)
    for use_native in (True, False):
        with pytest.raises(ValueError, match='smaller than one window'):
            token_loader.TokenLoader([str(p)], batch=1, seq=32,
                                     use_native=use_native)


def test_train_lm_reads_through_the_native_reader(tmp_path, native):
    for i, n in enumerate((1000, 1450, 3)):    # ids in llama-tiny's vocab
        (np.arange(n) % 512).astype(np.uint16).tofile(
            tmp_path / f'shard{i}.bin')
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.recipes.train_lm',
         '--cpu', '--model', 'llama-tiny', '--seq', '32', '--global-batch',
         '2', '--steps', '2', '--log-every', '1', '--data',
         str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert ('data: native reader (native/token_loader.cpp), 3 shards, '
            '2,453 tokens') in out.stdout
    assert 'step 2/2 loss=' in out.stdout
