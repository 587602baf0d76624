"""The port's token streams against the reference's, bitwise: the
synthetic LM stream and the memmap corpus over seeds and steps, and the
synthetic corpus file itself."""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.data as R  # noqa: E402
import repro_torch.data as T  # noqa: E402


@pytest.mark.parametrize("seed", [0, 5, 123])
@pytest.mark.parametrize("vocab,seq,batch,doc", [(256, 16, 4, 512),
                                                 (100, 33, 3, 8),
                                                 (128256, 64, 2, 512)])
def test_synthetic_lm_bitwise(seed, vocab, seq, batch, doc):
    ref = R.SyntheticLM(vocab, seq, batch, seed=seed, mean_doc_len=doc)
    port = T.SyntheticLM(vocab, seq, batch, seed=seed, mean_doc_len=doc)
    for step in (0, 1, 7, 1000):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    it_ref, it_port = iter(ref), iter(port)
    for _ in range(2):
        np.testing.assert_array_equal(next(it_ref)["tokens"],
                                      next(it_port)["tokens"])


@pytest.mark.parametrize("seed", [0, 9])
def test_memmap_corpus_bitwise(tmp_path, seed):
    ref_path = R.write_synthetic_corpus(str(tmp_path / "ref.bin"), 5000, 300,
                                        seed=seed)
    port_path = T.write_synthetic_corpus(str(tmp_path / "port.bin"), 5000,
                                         300, seed=seed)
    assert open(ref_path, "rb").read() == open(port_path, "rb").read()
    ref = R.MemmapCorpus(ref_path, seq_len=32, global_batch=6, seed=seed)
    port = T.MemmapCorpus(port_path, seq_len=32, global_batch=6, seed=seed)
    for step in (0, 3, 11):
        a, b = ref.batch_at(step), port.batch_at(step)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert b[k].dtype == np.int32


def test_memmap_corpus_too_small_raises(tmp_path):
    path = T.write_synthetic_corpus(str(tmp_path / "c.bin"), 100, 50)
    with pytest.raises(ValueError, match="corpus too small"):
        T.MemmapCorpus(path, seq_len=32, global_batch=8)
