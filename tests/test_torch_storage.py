"""The port's storage codec (``repro_torch/data/storage.py``) and the rest
of its joiners (``repro_torch/core/joiner.py``) held against the
reference's (``repro/data/storage.py``, ``repro/core/joiner.py``):

  * ``encode_roo_shard`` writes the reference's bytes for the simulator's
    joined samples (compressed, uncompressed, and the legacy v1 frame) and
    for random samples with ragged, empty and zero-impression structure;
  * each package decodes the other's blobs to equal samples;
  * one flipped byte raises ``ShardCorruptionError`` in both packages;
  * the impression-level codec, ``expand_roo_samples``,
    ``ImpressionLevelJoiner``, the byte accounting and
    ``sample_volume_increase`` agree with the reference.

The helpers here (``both_samples``, ``random_samples``,
``assert_same_samples``) also serve ``test_torch_pipeline*.py``.
"""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.core import joiner as jax_joiner
from repro.data import events as jax_events
from repro.data import storage as jax_storage
from repro.pipeline import joiner as jax_pipeline_joiner
from repro_torch.core import joiner
from repro_torch.data import events, storage
from repro_torch.pipeline import joiner as pipeline_joiner

STREAM = dict(n_requests=120, hist_init_max=40, seed=0, late_fraction=0.2)


def both_samples(**stream):
    """The same simulated stream joined online by each package's
    ``WatermarkJoiner``: (port samples, reference samples, port joiner,
    reference joiner)."""
    cfg = dict(STREAM, **stream)
    pj = pipeline_joiner.WatermarkJoiner()
    rj = jax_pipeline_joiner.WatermarkJoiner()
    ours = pj.join(events.EventSimulator(
        events.EventStreamConfig(**cfg)).stream())
    theirs = rj.join(jax_events.EventSimulator(
        jax_events.EventStreamConfig(**cfg)).stream())
    return ours, theirs, pj, rj


def random_samples(seed: int, cls):
    """Random ROO samples (of ``cls``, either package's ROOSample) with
    ragged, empty and zero-impression structure, the same draws for
    either class."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(r.randint(1, 6)):
        n_imp = int(r.randint(0, 4))
        out.append(cls(
            request_id=int(r.randint(0, 2 ** 31)),
            user_id=int(r.randint(0, 2 ** 31)),
            ro_dense=r.normal(size=(r.randint(0, 6),)).astype(np.float32),
            ro_idlist=r.randint(0, 2 ** 31, size=r.randint(0, 5)).tolist(),
            history_ids=r.randint(0, 2 ** 31,
                                  size=r.randint(0, 5)).tolist(),
            history_actions=r.randint(0, 2, size=r.randint(0, 5)).tolist(),
            item_ids=r.randint(0, 2 ** 31, size=n_imp).tolist(),
            item_dense=[r.normal(size=(r.randint(0, 4),)).astype(np.float32)
                        for _ in range(n_imp)],
            item_idlist=[r.randint(0, 2 ** 31, size=r.randint(0, 4)).tolist()
                         for _ in range(n_imp)],
            labels=[{"click": float(r.randint(0, 2)),
                     "view_sec": float(np.float32(r.rand() * 100))}
                    for _ in range(n_imp)]))
    return out


def _same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def assert_same_samples(ours, theirs):
    """Two lists of ROO samples (either package) field by field, exact."""
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert (a.request_id, a.user_id) == (b.request_id, b.user_id)
        _same_array(a.ro_dense, b.ro_dense)
        for f in ("ro_idlist", "history_ids", "history_actions",
                  "item_ids", "item_idlist", "labels"):
            assert getattr(a, f) == getattr(b, f), f
        assert len(a.item_dense) == len(b.item_dense)
        for x, y in zip(a.item_dense, b.item_dense):
            _same_array(x, y)


def assert_same_impressions(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for f in ("request_id", "user_id", "item_id", "labels",
                  "ro_idlist", "history_ids", "history_actions",
                  "item_idlist"):
            assert getattr(a, f) == getattr(b, f), f
        _same_array(a.ro_dense, b.ro_dense)
        _same_array(a.item_dense, b.item_dense)


@pytest.fixture(scope="module")
def joined():
    ours, theirs, _, _ = both_samples()
    return ours, theirs


# ---------------------------------------------------------------------------
# the ROO shard codec: the reference's bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress,crc", [(True, True), (False, True),
                                          (True, False)],
                         ids=["zlib", "raw", "v1-frame"])
def test_roo_shard_bytes_equal_the_reference(joined, compress, crc):
    ours, theirs = joined
    assert len(ours) == STREAM["n_requests"]
    blob = storage.encode_roo_shard(ours, compress=compress, crc=crc)
    assert blob == jax_storage.encode_roo_shard(theirs, compress=compress,
                                                crc=crc)
    header = storage.peek_shard_header(blob)
    assert header == jax_storage.peek_shard_header(blob)
    assert header["schema_version"] == (storage.SCHEMA_VERSION if crc else 1)
    assert header["ro_pool_size"] < 3 * len(ours)      # the dedup pools


@pytest.mark.parametrize("seed", range(6))
def test_random_samples_bytes_equal_the_reference(seed):
    ours = random_samples(seed, joiner.ROOSample)
    theirs = random_samples(seed, jax_joiner.ROOSample)
    blob = storage.encode_roo_shard(ours)
    assert blob == jax_storage.encode_roo_shard(theirs)
    assert_same_samples(storage.decode_roo_shard(blob),
                        jax_storage.decode_roo_shard(blob))


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 9999))
def test_property_bytes_and_roundtrip(seed):
    ours = random_samples(seed, joiner.ROOSample)
    blob = storage.encode_roo_shard(ours)
    assert blob == jax_storage.encode_roo_shard(
        random_samples(seed, jax_joiner.ROOSample))
    back = storage.decode_roo_shard(blob)
    assert len(back) == len(ours)
    for a, b in zip(back, ours):
        assert a.item_ids == [int(x) for x in b.item_ids]
        assert a.labels == [{k: float(np.float32(v)) for k, v in lab.items()}
                            for lab in b.labels]


@pytest.mark.parametrize("crc", [True, False], ids=["v2", "v1"])
def test_each_package_decodes_the_others_blobs(joined, crc):
    ours, theirs = joined
    from_ref = storage.decode_roo_shard(
        jax_storage.encode_roo_shard(theirs, crc=crc))
    from_port = jax_storage.decode_roo_shard(
        storage.encode_roo_shard(ours, crc=crc))
    assert all(isinstance(s, joiner.ROOSample) for s in from_ref)
    assert_same_samples(from_ref, from_port)
    assert_same_samples(from_ref, storage.decode_roo_shard(
        storage.encode_roo_shard(ours, crc=crc)))


def test_empty_and_zero_impression_shards():
    empty = storage.encode_roo_shard([])
    assert empty == jax_storage.encode_roo_shard([])
    assert storage.decode_roo_shard(empty) == []
    zero = random_samples(3, joiner.ROOSample)
    for s in zero:
        s.item_ids, s.item_dense, s.item_idlist, s.labels = [], [], [], []
    blob = storage.encode_roo_shard(zero)
    assert storage.peek_shard_header(blob)["n_impressions"] == 0
    assert [s.num_impressions for s in storage.decode_roo_shard(blob)] == \
        [0] * len(zero)


def test_flipped_byte_raises_in_both_packages(joined):
    ours, _ = joined
    blob = bytearray(storage.encode_roo_shard(ours[:20]))
    blob[len(blob) - 16] ^= 0xFF
    with pytest.raises(storage.ShardCorruptionError, match="CRC32"):
        storage.decode_roo_shard(bytes(blob))
    with pytest.raises(jax_storage.ShardCorruptionError, match="CRC32"):
        jax_storage.decode_roo_shard(bytes(blob))
    assert issubclass(storage.ShardCorruptionError, ValueError)
    with pytest.raises(storage.ShardCorruptionError, match="bad magic"):
        storage.decode_roo_shard(b"NOTASHRD" + bytes(blob[8:]))
    truncated = storage.encode_roo_shard(ours[:5])[:-7]
    with pytest.raises(storage.ShardCorruptionError):
        storage.decode_roo_shard(truncated)


def test_newer_schema_and_wrong_kind_refused(joined):
    ours, _ = joined
    hdr = {"schema": "roo", "schema_version": storage.SCHEMA_VERSION + 1}
    with pytest.raises(ValueError, match="newer"):
        storage.decode_roo_shard(storage._frame(hdr, []))
    imp = storage.encode_impression_shard(joiner.expand_roo_samples(ours[:3]))
    with pytest.raises(ValueError, match="expected roo shard"):
        storage.decode_roo_shard(imp)


# ---------------------------------------------------------------------------
# the impression level: codec, expansion, joiner, byte accounting
# ---------------------------------------------------------------------------

def test_expansion_and_impression_codec_match_the_reference(joined):
    ours, theirs = joined
    imp, jimp = (joiner.expand_roo_samples(ours),
                 jax_joiner.expand_roo_samples(theirs))
    assert len(imp) == sum(s.num_impressions for s in ours) > 0
    assert all(isinstance(s, joiner.ImpressionSample) for s in imp)
    assert_same_impressions(imp, jimp)
    blob = storage.encode_impression_shard(imp)
    assert blob == jax_storage.encode_impression_shard(jimp)
    assert_same_impressions(storage.decode_impression_shard(blob),
                            jax_storage.decode_impression_shard(blob))
    v1 = jax_storage.encode_impression_shard(jimp, crc=False)
    assert_same_impressions(storage.decode_impression_shard(v1),
                            jax_storage.decode_impression_shard(v1))


def test_impression_level_joiner_matches_the_reference():
    cfg = dict(STREAM, late_fraction=0.0)
    ours = joiner.ImpressionLevelJoiner().join(events.EventSimulator(
        events.EventStreamConfig(**cfg)).stream())
    theirs = jax_joiner.ImpressionLevelJoiner().join(
        jax_events.EventSimulator(
            jax_events.EventStreamConfig(**cfg)).stream())
    assert len(ours) > STREAM["n_requests"]
    assert_same_impressions(ours, theirs)


@pytest.mark.parametrize("compress", [True, False])
def test_byte_accounting_and_table4_ratio_match(joined, compress):
    ours, theirs = joined
    imp, jimp = (joiner.expand_roo_samples(ours),
                 jax_joiner.expand_roo_samples(theirs))
    assert storage.encode_roo_table(ours, compress) == \
        jax_storage.encode_roo_table(theirs, compress)
    assert storage.encode_impression_table(imp, compress) == \
        jax_storage.encode_impression_table(jimp, compress)
    got = storage.sample_volume_increase(imp, ours, compress)
    assert got == jax_storage.sample_volume_increase(jimp, theirs, compress)
    assert got["sample_volume_increase_pct"] > 0
