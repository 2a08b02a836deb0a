"""The port's replay buffer (tinycarlo_torch.train.replay) against the JAX
package's (tinycarlo_tpu/train/replay.py): the same inserts and samples,
with the JAX package's draws recomputed from its keys and injected into
the port (`idx=`), give equal storage, fill counts and batches, exactly;
the duplicate-slot rule; npz files crossing between the packages."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tinycarlo_torch.train import replay as prb
from tinycarlo_tpu.train import replay as jrb


def _example():
    return {"x": jnp.zeros((3, 2), jnp.float32), "m": jnp.zeros((), jnp.int32),
            "r": jnp.zeros((1,), jnp.float32)}


def _batch(rng, b):
    return {"x": rng.standard_normal((b, 3, 2)).astype(np.float32),
            "m": rng.integers(0, 3, b).astype(np.int32),
            "r": rng.standard_normal((b, 1)).astype(np.float32)}


def _port_example():
    return {k: torch.from_numpy(np.array(v)) for k, v in _example().items()}


def _assert_storage(pbuf, jbuf):
    assert int(pbuf.filled) == int(jbuf.filled)
    for k, v in jbuf.storage.items():
        np.testing.assert_array_equal(pbuf.storage[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_add_and_sample_match_jax():
    """Appends, the boundary batch (part append, part evict) and full-buffer
    evictions, then samples, with the JAX draws injected: equal."""
    rng = np.random.default_rng(0)
    size, b = 10, 4
    jbuf = jrb.create(size, _example())
    pbuf = prb.create(size, _port_example())
    assert pbuf.capacity == size and pbuf.filled.dtype == torch.int32
    for i in range(6):
        batch = _batch(rng, b)
        key = jax.random.key(i)
        evict = np.array(jax.random.randint(key, (b,), 0, size))
        jbuf = jrb.add_batch(jbuf, key, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        prb.add_batch(pbuf, {k: torch.from_numpy(v)
                             for k, v in batch.items()},
                      idx=torch.from_numpy(evict))
        _assert_storage(pbuf, jbuf)
        skey = jax.random.key(100 + i)
        want = jrb.sample(jbuf, skey, 5)
        idx = np.array(jax.random.randint(skey, (5,), 0, jbuf.filled))
        got = prb.sample(pbuf, 5, idx=torch.from_numpy(idx))
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    assert int(pbuf.filled) == size


def test_duplicate_slots_last_item_wins():
    """Two items of one batch that draw the same slot: the JAX package's
    CPU scatter (.at[idx].set) keeps the last, and so does the port; the
    port's rule holds for any number of repeats."""
    s = jnp.zeros((4, 2))
    idx = jnp.asarray([1, 2, 1, 1, 3, 2])
    x = jnp.arange(12.0).reshape(6, 2)
    got = np.asarray(s.at[idx].set(x))
    np.testing.assert_array_equal(got[1], [6.0, 7.0])
    np.testing.assert_array_equal(got[2], [10.0, 11.0])
    assert prb.last_writer(torch.as_tensor(np.array(idx))).tolist() == [
        3, 5, 3, 3, 4, 5]
    # a full buffer, every slot of the batch drawn among 3: repeats certain
    rng = np.random.default_rng(1)
    jbuf = jrb.create(3, _example())
    pbuf = prb.create(3, _port_example())
    for i in range(3):
        batch = _batch(rng, 8)
        key = jax.random.key(10 + i)
        evict = np.array(jax.random.randint(key, (8,), 0, 3))
        jbuf = jrb.add_batch(jbuf, key, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        prb.add_batch(pbuf, {k: torch.from_numpy(v)
                             for k, v in batch.items()},
                      idx=torch.from_numpy(evict))
        _assert_storage(pbuf, jbuf)


def test_generator_draws_stay_in_range():
    """Without injected indices: evictions in [0, size), samples in the
    filled prefix, the same draws for the same generator seed."""
    buf = prb.create(50, {"v": torch.zeros((), dtype=torch.int64)})
    prb.add_batch(buf, {"v": torch.arange(20)},
                  generator=torch.Generator().manual_seed(0))
    idx = prb.sample_indices(buf, 1000, torch.Generator().manual_seed(1))
    assert int(idx.min()) >= 0 and int(idx.max()) < 20
    again = prb.sample_indices(buf, 1000, torch.Generator().manual_seed(1))
    assert torch.equal(idx, again)
    s = prb.sample(buf, 7, torch.Generator().manual_seed(2))
    assert s["v"].shape == (7,) and bool((s["v"] < 20).all())


def test_npz_crosses_between_packages(tmp_path):
    """A buffer saved by either package loads in the other, equal."""
    rng = np.random.default_rng(2)
    batch = _batch(rng, 5)
    jbuf = jrb.add_batch(jrb.create(8, _example()), jax.random.key(0),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    jpath = str(tmp_path / "jax.npz")
    jrb.save(jbuf, jpath)
    _assert_storage(prb.load(jpath, device="cpu"), jbuf)
    pbuf = prb.add_batch(prb.create(8, _port_example()),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    ppath = str(tmp_path / "port.npz")
    prb.save(pbuf, ppath)
    back = jrb.load(ppath)
    assert back.size == 8
    _assert_storage(pbuf, back)
