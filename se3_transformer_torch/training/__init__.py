from .checkpoint import (
    CheckpointManager, ModelFamilyMismatch, snapshot_device_arrays,
)
from .dataset import PointCloudDataset, save_point_cloud_dataset
from .denoise import (
    DenoiseConfig, DenoiseTrainer, denoise_loss, denoise_loss_fn,
    flagship_batch, molecular_batch, property_loss, synthetic_protein_batch,
    synthetic_protein_batch_host,
)
from .guardian import PreemptionGuard
from .pipeline import (
    BatchProducer, BatchProducerError, PipelineStats, dataset_batch_source,
    device_prefetch,
)
from .recipes import (
    RECIPES, af2_refinement, egnn_stress, flagship, flagship_fast,
    molecular_edges, toy_denoise,
)
from .sidechainnet import convert_sidechainnet, tokenize_sequence
