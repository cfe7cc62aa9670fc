"""The port's configuration presets hold the values of the four shipped
YAML files (the card's machine has no ``yaml``), and ``validate`` has the
JAX package's quirk-Q9 check."""

import dataclasses

import pytest

from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_torch import config

PRESETS = {
    "brats_4mod": config.flagship,
    "brats_seg_stage2": lambda: config.seg_stage2("SET_ME_TO_STAGE1_RUN_DIR"),
    "zerodose_pet": config.zerodose,
    "ncanda_t1t2": config.ncanda,
}


@pytest.mark.parametrize("name", list(PRESETS))
def test_preset_equals_its_yaml(name):
    got = PRESETS[name]()
    want = config.load_config(f"configs/{name}.yaml").validate()
    for f in dataclasses.fields(config.Config):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("name", list(PRESETS))
def test_preset_fields_equal_the_jax_configs(name):
    """Every field both packages have, as the JAX package loads the YAML."""
    from representation_disentanglement_tpu.config import load_config
    got = PRESETS[name]()
    want = load_config(f"configs/{name}.yaml").validate()
    shared = {f.name for f in dataclasses.fields(JaxConfig)} & {
        f.name for f in dataclasses.fields(config.Config)}
    for k in sorted(shared - {"ckpt_path"}):
        assert getattr(got, k) == getattr(want, k), k


def test_stage2_preset_resumes_the_given_run_frozen():
    cfg = config.seg_stage2("2026_1_2_3_4")
    assert (cfg.ckpt_timelabel, cfg.load_yaml, cfg.continue_train,
            cfg.fix_pretrain, cfg.out_num_ch) == ("2026_1_2_3_4", False,
                                                   True, True, 4)


@pytest.mark.parametrize("out_num_ch,ok", [(1, False), (4, True)])
def test_validate_has_quirk_q9(out_num_ch, ok):
    """BraTS y-losses need 4 output channels, as in the JAX package."""
    for lam in ("lambda_recon_y", "lambda_recon_y_fused"):
        kw = {lam: 1.0, "out_num_ch": out_num_ch}
        for cls in (config.Config, JaxConfig):
            cfg = cls(**kw).derive()
            if ok:
                cfg.validate()
            else:
                with pytest.raises(ValueError, match="out_num_ch=4"):
                    cfg.validate()
    # other datasets keep one channel
    config.Config(dataset_name="ZeroDose", lambda_recon_y=1.0).validate()


@pytest.mark.parametrize("name", list(PRESETS))
def test_build_model_accepts_every_preset(name):
    """The model of each preset builds (at 32x64, on the CPU), with the
    discriminator and the prior when the adversarial and KL losses ask."""
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    cfg = PRESETS[name]()
    cfg.input_height, cfg.input_width = 32, 64
    cfg.lambda_adv_s, cfg.lambda_kl, cfg.is_distri_z = 0.1, 0.01, True
    model = build_model(cfg.derive().validate(), device="cpu")
    assert model.modality_num == len(cfg.contrast_list)
    assert model.is_discrim_s and model.is_distri_z
    assert model.output_decoder.output.up[1].weight.shape[0] == \
        cfg.out_num_ch
