"""Vocos-style discriminator bundle, MPD + MRD, with the three loss entry
points (port of `optispeech_tpu/models/discriminator/vocos.py`):
- forward_disc: hinge D loss, the mean per family, MRD weighted by lambda_mrd;
- forward_gen: hinge G loss + feature matching + mel L1 (x45) + MR-STFT (x2.5);
- forward_val: mel L1 + MR-STFT only.
Each returns (loss, log dict). Submodule names follow the reference's
torch keys (`multiperioddisc`, `multiresddisc`).
"""

from torch import nn

from ...config import DiscriminatorConfig, FeatureConfig
from .critics import MultiPeriodDiscriminator, MultiResolutionDiscriminator
from .losses import (
    discriminator_adv_loss,
    feature_matching_loss,
    generator_adv_loss,
    mel_spec_reconstruction_loss,
    multi_resolution_stft_loss,
)


class VocosDiscriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig, features: FeatureConfig):
        super().__init__()
        self.cfg = cfg
        self.features = features
        self.multiperioddisc = MultiPeriodDiscriminator(tuple(cfg.periods))
        self.multiresddisc = MultiResolutionDiscriminator(tuple(cfg.resolutions),
                                                          cfg.mrd_channels)

    def _mel_loss(self, wav, wav_hat):
        f = self.features
        return self.cfg.loss_coeffs.lambda_mel * mel_spec_reconstruction_loss(
            wav_hat, wav, f.sample_rate, f.n_fft, f.hop_length, f.win_length, f.n_feats,
            f.f_min, f.f_max)

    def _mr_stft_loss(self, wav, wav_hat):
        sc, mag = multi_resolution_stft_loss(wav_hat, wav)
        return self.cfg.loss_coeffs.lambda_mr_stft * (sc + mag)

    def forward_disc(self, wav, wav_hat):
        lam_mrd = self.cfg.loss_coeffs.lambda_mrd
        real_mp, gen_mp, _, _ = self.multiperioddisc(wav, wav_hat)
        real_mrd, gen_mrd, _, _ = self.multiresddisc(wav, wav_hat)
        loss_mp, r_mp, _ = discriminator_adv_loss(real_mp, gen_mp)
        loss_mrd, r_mrd, _ = discriminator_adv_loss(real_mrd, gen_mrd)
        loss_mp = loss_mp / len(r_mp)
        loss_mrd = loss_mrd / len(r_mrd)
        return loss_mp + lam_mrd * loss_mrd, {"loss_mp": loss_mp, "loss_mrd": loss_mrd}

    def forward_gen(self, wav, wav_hat):
        lam_mrd = self.cfg.loss_coeffs.lambda_mrd
        _, gen_mp, fr_mp, fg_mp = self.multiperioddisc(wav, wav_hat)
        _, gen_mrd, fr_mrd, fg_mrd = self.multiresddisc(wav, wav_hat)
        loss_gen_mp, l_mp = generator_adv_loss(gen_mp)
        loss_gen_mrd, l_mrd = generator_adv_loss(gen_mrd)
        loss_gen_mp = loss_gen_mp / len(l_mp)
        loss_gen_mrd = loss_gen_mrd / len(l_mrd)
        loss_fm_mp = feature_matching_loss(fr_mp, fg_mp) / len(fr_mp)
        loss_fm_mrd = feature_matching_loss(fr_mrd, fg_mrd) / len(fr_mrd)
        mel_loss = self._mel_loss(wav, wav_hat)
        mr_stft_loss = self._mr_stft_loss(wav, wav_hat)
        loss = (loss_gen_mp + lam_mrd * loss_gen_mrd + loss_fm_mp + lam_mrd * loss_fm_mrd
                + mel_loss + mr_stft_loss)
        return loss, {
            "loss_gen_mp": loss_gen_mp, "loss_gen_mrd": loss_gen_mrd,
            "loss_fm_mp": loss_fm_mp, "loss_fm_mrd": loss_fm_mrd,
            "mel_loss": mel_loss, "mr_stft_loss": mr_stft_loss,
        }

    def forward_val(self, wav, wav_hat):
        mel_loss = self._mel_loss(wav, wav_hat)
        mr_stft_loss = self._mr_stft_loss(wav, wav_hat)
        return mel_loss + mr_stft_loss, {"mel_loss": mel_loss, "mr_stft_loss": mr_stft_loss}
