"""Vocos-style discriminator bundle, MPD + MRD, with the three loss entry
points (port of `optispeech_tpu/models/discriminator/vocos.py`):
- forward_disc: hinge D loss, the mean per family, MRD weighted by lambda_mrd;
- forward_gen: hinge G loss + feature matching + mel L1 (x45) + MR-STFT (x2.5);
- forward_val: mel L1 + MR-STFT only.
Each returns (loss, log dict). Submodule names follow the reference's
torch keys (`multiperioddisc`, `multiresddisc`). With a data-parallel
`mesh` (`parallel/mesh.py`) each loss and log is this rank's share of the
global batch's: the means over its fixed-size segments over the world
size, the spectral convergence through `losses._global_norm_ratio`.
"""

from torch import nn

from ...config import DiscriminatorConfig, FeatureConfig
from ...parallel.mesh import mean_share
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

    def _mel_loss(self, wav, wav_hat, mesh=None):
        f = self.features
        loss = self.cfg.loss_coeffs.lambda_mel * mel_spec_reconstruction_loss(
            wav_hat, wav, f.sample_rate, f.n_fft, f.hop_length, f.win_length, f.n_feats,
            f.f_min, f.f_max)
        return mean_share(loss, mesh)

    def _mr_stft_loss(self, wav, wav_hat, mesh=None):
        sc, mag = multi_resolution_stft_loss(wav_hat, wav, mesh=mesh)
        return self.cfg.loss_coeffs.lambda_mr_stft * (sc + mag)

    def forward_disc(self, wav, wav_hat, mesh=None):
        lam_mrd = self.cfg.loss_coeffs.lambda_mrd
        real_mp, gen_mp, _, _ = self.multiperioddisc(wav, wav_hat)
        real_mrd, gen_mrd, _, _ = self.multiresddisc(wav, wav_hat)
        loss_mp, r_mp, _ = discriminator_adv_loss(real_mp, gen_mp)
        loss_mrd, r_mrd, _ = discriminator_adv_loss(real_mrd, gen_mrd)
        loss_mp = mean_share(loss_mp / len(r_mp), mesh)
        loss_mrd = mean_share(loss_mrd / len(r_mrd), mesh)
        return loss_mp + lam_mrd * loss_mrd, {"loss_mp": loss_mp, "loss_mrd": loss_mrd}

    def forward_gen(self, wav, wav_hat, mesh=None):
        lam_mrd = self.cfg.loss_coeffs.lambda_mrd
        _, gen_mp, fr_mp, fg_mp = self.multiperioddisc(wav, wav_hat)
        _, gen_mrd, fr_mrd, fg_mrd = self.multiresddisc(wav, wav_hat)
        loss_gen_mp, l_mp = generator_adv_loss(gen_mp)
        loss_gen_mrd, l_mrd = generator_adv_loss(gen_mrd)
        loss_gen_mp = mean_share(loss_gen_mp / len(l_mp), mesh)
        loss_gen_mrd = mean_share(loss_gen_mrd / len(l_mrd), mesh)
        loss_fm_mp = mean_share(feature_matching_loss(fr_mp, fg_mp) / len(fr_mp), mesh)
        loss_fm_mrd = mean_share(feature_matching_loss(fr_mrd, fg_mrd) / len(fr_mrd), mesh)
        mel_loss = self._mel_loss(wav, wav_hat, mesh)
        mr_stft_loss = self._mr_stft_loss(wav, wav_hat, mesh)
        loss = (loss_gen_mp + lam_mrd * loss_gen_mrd + loss_fm_mp + lam_mrd * loss_fm_mrd
                + mel_loss + mr_stft_loss)
        return loss, {
            "loss_gen_mp": loss_gen_mp, "loss_gen_mrd": loss_gen_mrd,
            "loss_fm_mp": loss_fm_mp, "loss_fm_mrd": loss_fm_mrd,
            "mel_loss": mel_loss, "mr_stft_loss": mr_stft_loss,
        }

    def forward_val(self, wav, wav_hat, mesh=None):
        mel_loss = self._mel_loss(wav, wav_hat, mesh)
        mr_stft_loss = self._mr_stft_loss(wav, wav_hat, mesh)
        return mel_loss + mr_stft_loss, {"mel_loss": mel_loss, "mr_stft_loss": mr_stft_loss}
