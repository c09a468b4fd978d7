from .sampler import (SAMPLER_STREAM_VERSION, SAMPLERS, BallsAndBinsSampler,
                      FullBatchSampler, PoissonSampler, ShuffleSampler,
                      available_samplers, make_sampler, register_sampler,
                      resolve_sampler, sampler_accounting, step_rng)
from .loader import BatchMemoryManager, PhysicalBatch
from .synthetic import (EmbeddingDataset, ImageDataset, TokenDataset,
                        dataset_for_config)

__all__ = ["PoissonSampler", "ShuffleSampler", "BallsAndBinsSampler",
           "FullBatchSampler", "SAMPLERS", "SAMPLER_STREAM_VERSION",
           "available_samplers", "make_sampler", "register_sampler",
           "resolve_sampler", "sampler_accounting", "step_rng",
           "BatchMemoryManager", "PhysicalBatch", "EmbeddingDataset",
           "ImageDataset", "TokenDataset", "dataset_for_config"]
