"""The RDP accountant: numpy copies of the reference package's modules."""
from .rdp import (rdp_subsampled_gaussian, rdp_gaussian, compose, compose_for,
                  rdp_to_eps, epsilon, epsilon_for, calibrate_sigma,
                  DEFAULT_ALPHAS)
from .accountant import PrivacyAccountant

__all__ = ["rdp_subsampled_gaussian", "rdp_gaussian", "compose",
           "compose_for", "rdp_to_eps", "epsilon", "epsilon_for",
           "calibrate_sigma", "DEFAULT_ALPHAS", "PrivacyAccountant"]
