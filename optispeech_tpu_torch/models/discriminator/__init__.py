"""Vocoder discriminators (GAN critics) and their losses."""

from .critics import init_discriminator, torch_weight_norm_init
from .vocos import VocosDiscriminator

__all__ = ["VocosDiscriminator", "init_discriminator", "torch_weight_norm_init"]
