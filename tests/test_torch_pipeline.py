"""The port's input pipeline against the JAX package's: BatchProducer
(order, errors, retries, close), device_prefetch on the CPU,
dataset_batch_source, the sidechainnet fixture's conversion and
PointCloudDataset, and the host graph builder (native/loader.py: the
g++-built library and its NumPy fallback) against
se3_transformer_tpu/native/loader.py."""
import os
import threading

import numpy as np
import pytest
import torch

from se3_transformer_tpu.native import loader as jloader
from se3_transformer_tpu.training import dataset as jdataset
from se3_transformer_tpu.training import pipeline as jpipeline
from se3_transformer_tpu.training import sidechainnet as jscn
from se3_transformer_torch.native import loader
from se3_transformer_torch.training import cli
from se3_transformer_torch.training import dataset as tdataset
from se3_transformer_torch.training import pipeline as tpipeline
from se3_transformer_torch.training import sidechainnet as tscn
from se3_transformer_torch.utils.graph import chain_adjacency

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'mini_sidechainnet.pkl')
SPLITS = ('train', 'valid-10', 'test')


# ---------------------------------------------------------------------- #
# BatchProducer and device_prefetch
# ---------------------------------------------------------------------- #
def test_producer_keeps_order_and_ends_cleanly():
    with tpipeline.BatchProducer(iter(range(20)), capacity=3) as producer:
        assert list(producer) == list(range(20))
        assert producer.puts == producer.gets == 20


def test_producer_reraises_a_source_error():
    def source():
        yield 1
        raise KeyError('bad batch')
    with tpipeline.BatchProducer(source()) as producer:
        assert next(producer) == 1
        with pytest.raises(tpipeline.BatchProducerError) as info:
            next(producer)
    assert isinstance(info.value.__cause__, KeyError)


def test_producer_retries_and_skips_a_build_fn():
    seen = []

    def build(i):
        seen.append(i)
        if i == 1 and seen.count(1) < 2:
            raise OSError('transient')
        if i == 3:
            raise ValueError('poison')
        if i == 5:
            raise StopIteration
        return i
    with tpipeline.BatchProducer(build, max_retries=2, retry_backoff_s=0.001,
                                 max_skips=1) as producer:
        assert list(producer) == [0, 1, 2, 4]
        assert (producer.retries, producer.skipped) == (3, 1)


def test_producer_close_stops_a_fast_source_without_leaking():
    before = threading.active_count()
    producer = tpipeline.BatchProducer(lambda i: i, capacity=2)
    assert next(producer) == 0
    producer.close(timeout=2)
    producer.close(timeout=2)          # idempotent
    assert not producer._thread.is_alive()
    assert threading.active_count() <= before


def test_device_prefetch_on_the_cpu_yields_tensors_in_order():
    batches = [dict(x=np.full((2, 3), i, np.float32),
                    adj=np.broadcast_to(np.eye(3, dtype=bool), (2, 3, 3)))
               for i in range(6)]
    stats = tpipeline.PipelineStats(depth=2, capacity=3)
    with tpipeline.BatchProducer(iter(batches), capacity=3) as producer:
        stats.bind_source(producer)
        got = list(tpipeline.device_prefetch(producer, depth=2, device='cpu',
                                             stats=stats))
    assert len(got) == 6
    for i, b in enumerate(got):
        assert isinstance(b['x'], torch.Tensor) and float(b['x'][0, 0]) == i
        assert b['adj'].shape == (2, 3, 3) and b['adj'].is_contiguous()
    snap = stats.snapshot()
    assert snap['steps'] == 6 and snap['prefetch']['hits'] + \
        snap['prefetch']['stalls'] == 6
    assert snap['verdict'] == stats.verdict()
    assert snap['source'] == dict(retries=0, skipped=0)
    with pytest.raises(ValueError):
        next(tpipeline.device_prefetch(iter(batches), depth=0, device='cpu'))


@pytest.mark.parametrize('hits,stalls,verdict', [
    (9, 1, 'device_bound'), (3, 7, 'producer_bound'), (6, 4, 'balanced')])
def test_stats_verdict_is_jax_s(hits, stalls, verdict):
    for mod in (tpipeline, jpipeline):
        s = mod.PipelineStats(depth=2)
        for _ in range(hits):
            s.record_get(True)
        for _ in range(stalls):
            s.record_get(False)
        assert s.verdict() == verdict


# ---------------------------------------------------------------------- #
# sidechainnet, the dataset, dataset_batch_source
# ---------------------------------------------------------------------- #
def test_fixture_conversion_is_jax_s(tmp_path):
    ref = jscn.convert_sidechainnet(FIXTURE, str(tmp_path / 'jax.npz'),
                                    splits=SPLITS)
    got = tscn.convert_sidechainnet(FIXTURE, str(tmp_path / 'port.npz'),
                                    splits=SPLITS)
    with np.load(ref) as a, np.load(got) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(tscn.tokenize_sequence('ACXZY'),
                                  jscn.tokenize_sequence('ACXZY'))
    ds = tdataset.PointCloudDataset.load(got)
    jds = jdataset.PointCloudDataset.load(ref)
    assert len(ds) == len(jds) == 5
    for i in range(5):
        for x, y in zip(ds.sequence(i), jds.sequence(i)):
            np.testing.assert_array_equal(x, y)
    with pytest.warns(UserWarning, match='dropped 2'):
        got_b = list(ds.batches(1, buckets=(96,), shuffle_seed=3))
    with pytest.warns(UserWarning):
        ref_b = list(jds.batches(1, buckets=(96,), shuffle_seed=3))
    assert ds.last_dropped == 2 and len(got_b) == len(ref_b) == 3
    for a, b in zip(got_b, ref_b):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])


def test_dataset_batch_source_is_jax_s(tmp_path):
    path = tscn.convert_sidechainnet(FIXTURE, str(tmp_path / 'd.npz'),
                                     splits=SPLITS)
    ds = tdataset.PointCloudDataset.load(path)
    with pytest.warns(UserWarning):
        got = list(tpipeline.dataset_batch_source(ds, 1, 96, accum_steps=4,
                                                  num_steps=3))
    with pytest.warns(UserWarning):
        ref = list(jpipeline.dataset_batch_source(
            jdataset.PointCloudDataset.load(path), 1, 96, accum_steps=4,
            num_steps=3))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert sorted(a) == ['adj_mat', 'coords', 'masks', 'seqs']
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
    assert got[0]['seqs'].shape == (4, 1, 96)
    with pytest.raises(ValueError, match='empty dataset'):
        tpipeline.dataset_batch_source(tdataset.PointCloudDataset(
            np.zeros(0, np.int64), np.zeros(0, np.int32),
            np.zeros((0, 3), np.float32)), 1, 96)


def test_save_rejects_mismatched_sequences(tmp_path):
    with pytest.raises(ValueError, match='tokens vs'):
        tdataset.save_point_cloud_dataset(str(tmp_path / 'x'), [np.zeros(3)],
                                          [np.zeros((4, 3))])


def test_cli_trains_from_the_converted_fixture(tmp_path, capsys):
    path = tscn.convert_sidechainnet(FIXTURE, str(tmp_path / 'd.npz'),
                                     splits=SPLITS)
    with pytest.warns(UserWarning):
        history = cli.main(['--cpu', '--steps', '2', '--nodes', '96',
                            '--accum', '2', '--dataset', path,
                            '--pipelined'])
    assert history[-1]['kind'] == 'pipeline' and history[-1]['steps'] == 2
    assert all(np.isfinite(h['loss']) for h in history[:-1])


# ---------------------------------------------------------------------- #
# the host graph builder, built and in its NumPy fallback
# ---------------------------------------------------------------------- #
def test_host_paths_never_ask_for_the_graph_library(tmp_path, monkeypatch):
    # the engine, the synthetic batches and the dataset pad and build
    # adjacency in NumPy (utils/graph.py); only the loader's own functions
    # build graph_builder.cpp
    from se3_transformer_torch import InferenceEngine, toy_denoise
    from se3_transformer_torch.training import DenoiseConfig
    from se3_transformer_torch.training.denoise import (
        synthetic_protein_batch_host,
    )

    def refuse():
        raise AssertionError('the native library was asked for')
    monkeypatch.setattr(loader, 'get_lib', refuse)
    InferenceEngine(toy_denoise(device='cpu'), buckets=(16,), device='cpu')
    batch = synthetic_protein_batch_host(DenoiseConfig(num_nodes=12),
                                         np.random.RandomState(0))
    np.testing.assert_array_equal(batch['adj_mat'][0],
                                  jloader.chain_adjacency(12))
    path = tscn.convert_sidechainnet(FIXTURE, str(tmp_path / 'd.npz'),
                                     splits=SPLITS)
    with pytest.warns(UserWarning):
        got = list(tdataset.PointCloudDataset.load(path).batches(
            1, buckets=(96,)))
    assert len(got) == 3 and got[0]['adj_mat'].shape == (96, 96)


@pytest.fixture(params=['native', 'numpy'])
def graph_lib(request, monkeypatch):
    if request.param == 'native':
        assert loader.native_available(), 'g++ could not build the library'
    else:
        monkeypatch.setattr(loader, 'get_lib', lambda: None)
    return request.param


def test_graph_builder_matches_jax_s(graph_lib):
    rng = np.random.RandomState(4)
    np.testing.assert_array_equal(loader.chain_adjacency(11),
                                  jloader.chain_adjacency(11))
    assert loader.chain_adjacency(11).dtype == bool
    np.testing.assert_array_equal(chain_adjacency(7),
                                  jloader.chain_adjacency(7))
    adj = rng.rand(9, 9) < 0.2
    adj = adj | adj.T
    for got, ref in zip(loader.expand_adjacency(adj, 3),
                        jloader.expand_adjacency(adj, 3)):
        np.testing.assert_array_equal(got, ref)
    coords = rng.normal(size=(2, 13, 3)).astype(np.float32)
    for got, ref in zip(loader.knn_graph(coords, 5, radius=1.5),
                        jloader.knn_graph(coords, 5, radius=1.5)):
        np.testing.assert_array_equal(got, ref)
    toks = [rng.randint(0, 20, n) for n in (5, 9, 3)]
    crds = [rng.normal(size=(n, 3)) for n in (5, 9, 3)]
    for got, ref in zip(loader.pad_batch(toks, crds),
                        jloader.pad_batch(toks, crds)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(loader.pad_to_bucket(toks, crds, 8, batch_size=5),
                        jloader.pad_to_bucket(toks, crds, 8, batch_size=5)):
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        loader.pad_to_bucket(toks, crds, 8, batch_size=2)


def test_the_library_is_the_port_s_own():
    assert loader.native_available()
    path = loader.library_path()
    assert path.startswith(os.path.dirname(loader.__file__))
    assert os.path.exists(path)
