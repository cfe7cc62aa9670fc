"""The legacy generator variants of the port (models/legacy_generators.py)
against the JAX package's on the CPU, with the same weights carried over by
``weights.from_jax_legacy``: each of the nine factories (parametrised), the
8-channel stroke split layout (``SPLIT8``) and the 8-down split generator
``GANStandardGeneratorWithSplitInputChannelAttentionOne`` (256x256 at
first_num_ch 4), each in eval mode and in train mode with the updated
running statistics and the attention maps; the gradient of the deepest
variant (split input, channel attention on the concat and at every level,
symmetry-gate residual gates) leaf by leaf.  B = 2, f32, 64x64 and
first_num_ch 8 unless stated (the MultiAttention variant needs 128x128,
at first_num_ch 16 so that its 1-level gate keeps a channel).
"""

import pytest
import torch

from representation_disentanglement_tpu.models import (
    legacy_generators as JLG)
from representation_disentanglement_torch.models import (
    legacy_generators as LG)
import torch_legacy_common as C

few_threads = pytest.fixture(scope="module", autouse=True)(C.few_threads)

# the biases that a train-mode BatchNorm follows
CANCELLED = r"(down_\d\.conv\.0|up_\d\.up\.1|W_out\.0)\.bias$"


def _pair(name, in_ch=3, size=64, f=8, seed=1):
    factory = LG.FACTORIES[name]
    jm = getattr(JLG, factory.__name__)(
        out_num_ch=1, first_num_ch=f, output_activation="no",
        **({"in_num_ch": in_ch} if in_ch != 3 else {}))
    tm = factory(1, in_num_ch=in_ch, first_num_ch=f, output_activation="no",
                 device="cpu")
    x = C.seeded((2, in_ch, size, size), seed)
    return C.LegacyPair(jm, tm, "generator", (C.nhwc(x),),
                        (torch.from_numpy(x),))


@pytest.mark.parametrize("name", sorted(LG.FACTORIES))
def test_legacy_generator_parity(name):
    multi = name == "split_multi"
    p = _pair(name, size=128 if multi else 64, f=16 if multi else 8)
    p.check(name)
    assert sorted(p.tm.eval()(*p.targs)[1]) == [
        f"alpha_{i}" for i in range(1, 5)]


def test_split8_layout_parity():
    p = _pair("split_ca_all_sa", in_ch=8, seed=2)
    assert [m.weight.shape[1] for m in (p.tm.down_1_1[0], p.tm.down_1_2[0],
                                        p.tm.down_1_3[0], p.tm.down_1_4[0])
            ] == [1, 2, 2, 3]
    p.check("split8")


def test_deepest_variant_grads():
    _pair("split_ca_all_sa", seed=3).check_grads("split_ca_all_sa",
                                                 cancelled=CANCELLED)


def test_standard_split_ca_one_parity():
    jm = JLG.GANStandardGeneratorWithSplitInputChannelAttentionOne(
        out_num_ch=1, first_num_ch=4, output_activation="no")
    tm = LG.GANStandardGeneratorWithSplitInputChannelAttentionOne(
        1, first_num_ch=4, output_activation="no", device="cpu")
    x = C.seeded((2, 4, 256, 256), 4)
    C.LegacyPair(jm, tm, "generator", (C.nhwc(x),),
                 (torch.from_numpy(x),)).check("standard split")


def test_unknown_attention_refused():
    with pytest.raises(ValueError, match="unknown attention"):
        LG._LegacyAttGenerator(3, 1, "nope", device="cpu")
