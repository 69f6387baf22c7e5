"""The port's token loader (``data/dataloader.py``): a mirror of
``tests/data/test_dataloader.py`` (native == numpy bit for bit, permutation
coverage, shard disjointness, epoch flush, close semantics), and the
port's windows equal to the JAX ``TokenDataset``'s byte for byte, for the
same file, seeds, epochs and shards, on the native route and on the numpy
route. The port builds ``native/dataloader.cpp`` into ``build/native/``."""
import os
import time

import numpy as np
import pytest

from pipegoose_tpu.data import TokenDataset as JaxTokenDataset
from pipegoose_tpu_torch.data import TokenDataset, write_token_file
from pipegoose_tpu_torch.data import dataloader as tdl


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "tokens.bin")
    # token value encodes its global position -> windows identifiable
    write_token_file(np.arange(64 * 128, dtype=np.uint32), path)
    return path


def test_native_loader_builds_into_build_native_and_yields(token_file):
    ds = TokenDataset(token_file, batch=4, seq=16, native=True)
    assert ds.route == "native"
    assert os.path.dirname(tdl._NATIVE_SO).endswith(os.path.join("build", "native"))
    assert os.path.exists(tdl._NATIVE_SO)
    batches = ds.take(3)
    ds.close()
    assert all(b.shape == (4, 16) and b.dtype == np.uint32 for b in batches)
    for b in batches:
        assert (b[:, 0] % 16 == 0).all()  # contiguous windows
        np.testing.assert_array_equal(b[0], np.arange(b[0, 0], b[0, 0] + 16))


def test_native_matches_numpy(token_file):
    for epoch in (0, 3):
        a = TokenDataset(token_file, batch=4, seq=16, seed=7, native=True)
        b = TokenDataset(token_file, batch=4, seq=16, seed=7, native=False)
        assert (a.route, b.route) == ("native", "numpy")
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        xa, xb = a.take(6), b.take(6)
        a.close()
        for x, y in zip(xa, xb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_windows_equal_the_jax_loaders(token_file, native):
    """Byte for byte against the JAX TokenDataset (on its own route) for
    the same file, seeds, epochs and shards."""
    for seed, world, rank in ((0, 1, 0), (7, 2, 1), (3, 4, 2)):
        for epoch in (0, 1, 5):
            a = TokenDataset(token_file, batch=4, seq=16, rank=rank, world=world,
                             seed=seed, native=native)
            b = JaxTokenDataset(token_file, batch=4, seq=16, rank=rank, world=world,
                                seed=seed, native=native)
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            n = a.steps_per_epoch()
            assert n == b.steps_per_epoch() and n > 0
            for x, y in zip(a.take(n), b.take(n)):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
            a.close()
            b.close()


def test_epoch_covers_every_window_once(token_file):
    ds = TokenDataset(token_file, batch=4, seq=16, rank=1, world=2, seed=3)
    steps = ds.steps_per_epoch()
    seen = []
    for b in ds.take(steps):
        seen.extend((b[:, 0] // 16).tolist())
    ds.close()
    assert sorted(seen) == sorted(set(seen)), "windows repeated within epoch"
    assert len(seen) == ds.batch * steps
    assert all(w % 2 == 1 for w in seen)  # rank-1 shard only


def test_set_epoch_flushes_prefetched_batches(token_file):
    ds = TokenDataset(token_file, batch=4, seq=16, seed=1, native=True)
    time.sleep(0.1)  # let the worker fill the whole ring with epoch 0
    ref0 = TokenDataset(token_file, batch=4, seq=16, seed=1, native=False).take(4)
    r1 = TokenDataset(token_file, batch=4, seq=16, seed=1, native=False)
    r1.set_epoch(1)
    ref1 = r1.take(4)
    ds.set_epoch(1)
    got = ds.take(4)
    ds.close()
    for g, r in zip(got, ref1):
        np.testing.assert_array_equal(g, r)
    assert not all(np.array_equal(g, r) for g, r in zip(got, ref0))


def test_shards_are_disjoint(token_file):
    for rank in range(2):
        ds = TokenDataset(token_file, batch=4, seq=16, rank=rank, world=2)
        for b in ds.take(10):
            assert ((b[:, 0] // 16) % 2 == rank).all()
        ds.close()


def test_closed_dataset_raises(token_file):
    ds = TokenDataset(token_file, batch=4, seq=16)
    ds.take(1)
    ds.close()
    with pytest.raises(RuntimeError, match="closed"):
        ds.take(1)
    with pytest.raises(RuntimeError, match="closed"):
        _ = ds.windows_per_epoch


def test_tiny_file_takes_the_numpy_route_and_raises(token_file, tmp_path):
    tiny = str(tmp_path / "tiny.bin")
    write_token_file(np.arange(10, dtype=np.uint32), tiny)
    ds = TokenDataset(tiny, batch=4, seq=16)
    assert ds.route == "numpy"
    with pytest.raises(Exception):
        ds.take(1)


def test_second_iterator_invalidates_first(token_file):
    ds = TokenDataset(token_file, batch=2, seq=4, native=False)
    it1 = iter(ds)
    next(it1)
    it2 = iter(ds)
    next(it2)  # newest iterator works
    with pytest.raises(RuntimeError, match="newer iterator"):
        next(it1)
    ds.close()


def test_numpy_iterator_resets_on_set_epoch(token_file):
    ds = TokenDataset(token_file, batch=2, seq=4, native=False)
    it = iter(ds)
    first_epoch0 = next(it).copy()
    next(it)
    ds.set_epoch(0)
    np.testing.assert_array_equal(next(it), first_epoch0)
    ds.set_epoch(1)
    assert not np.array_equal(next(it), first_epoch0)
    ds.set_epoch(0)
    np.testing.assert_array_equal(next(it), first_epoch0)
    ds.close()
