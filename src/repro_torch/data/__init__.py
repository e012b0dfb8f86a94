from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.data.pipeline import DataPipeline

__all__ = ["SyntheticLMDataset", "DataPipeline"]
