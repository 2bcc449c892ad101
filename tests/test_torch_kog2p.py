"""The port's Korean G2P (``mlvae_tpu_torch/utils/kog2p.py``) against the
JAX package's (``mlvae_tpu/utils/kog2p.py``): the same rulebook, and the
same outputs on the golden lexicon of ``tests/test_kog2p_parity.py`` and
on random Hangul text made from a seed with numpy."""
import numpy as np
import pytest

from mlvae_tpu.utils import kog2p as jk
from mlvae_tpu_torch.utils import kog2p as pk
from test_kog2p_parity import GOLDEN


def test_rulebook_is_the_same():
    assert pk.DEFAULT_RULES == jk.DEFAULT_RULES
    assert len(pk.DEFAULT_RULES) == 184


@pytest.mark.parametrize("text,expected", GOLDEN, ids=[t for t, _ in GOLDEN])
def test_golden_lexicon_matches(text, expected):
    assert pk.g2p_prono(text) == jk.g2p_prono(text) == expected
    assert pk.g2p(text) == jk.g2p(text) == expected.split()
    assert pk.graph2phone(text) == jk.graph2phone(text)
    assert pk.decompose(text) == jk.decompose(text)


def _random_text(rs, n_words):
    words = []
    for _ in range(n_words):
        syl = rs.randint(0xAC00, 0xD7A4, size=rs.randint(1, 5))
        words.append("".join(chr(int(c)) for c in syl))
    return " ".join(words)


@pytest.mark.parametrize("seed", range(4))
def test_random_hangul_matches(seed):
    rs = np.random.RandomState(seed)
    for _ in range(25):
        text = _random_text(rs, rs.randint(1, 4))
        assert pk.g2p_prono(text) == jk.g2p_prono(text), text
        assert pk.graph2phone(text) == jk.graph2phone(text), text


def test_external_rulebook_reads_alike(tmp_path):
    path = tmp_path / "rulebook.txt"
    path.write_text("# a comment line\nkf,nn\tng,nn\nmf,rr\tmf,nn\n",
                    encoding="utf-8")
    assert pk.read_rules(str(path)) == jk.read_rules(str(path))
    for text, _ in GOLDEN[:8]:
        assert pk.g2p(text, str(path)) == jk.g2p(text, str(path))
