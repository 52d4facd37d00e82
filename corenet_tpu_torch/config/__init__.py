"""Typed configurations and their loading from JSON5 files."""

from corenet_tpu_torch.config.config import (  # noqa: F401
    DataLoaderConfig,
    DataPipeline,
    Dataset,
    EvalConfig,
    RecurrentEvalConfig,
    Resolution,
    ShuffleType,
    StringTemplate,
    TaskType,
    TfModelEvalPipeline,
    TrainConfig,
    TrainPipeline,
    VoxelizationConfig,
    config_from_dict,
    config_to_dict,
    parse_template_mapping,
    replace_templates,
)
from corenet_tpu_torch.config.loader import (  # noqa: F401
    apply_set_overrides,
    load_config_file,
    post_process_config,
)
