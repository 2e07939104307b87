"""The (data, model) process grid and its collectives."""

from .collectives import (
    data_shard_rows,
    fetch_global,
    gather_model_rows,
    gather_model_rows_bkl,
    model_handoff,
    model_row_sum,
    psum_data,
    psum_model,
    scatter_add_model_shard,
    scatter_add_model_shard_bkl,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ProcessGrid,
    agree_checkpoint_exists,
    check_backend,
    default_backend,
    initialize_distributed,
    is_coordinator,
    make_grid,
    run_grid,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "ProcessGrid",
    "agree_checkpoint_exists",
    "check_backend",
    "data_shard_rows",
    "default_backend",
    "fetch_global",
    "gather_model_rows",
    "gather_model_rows_bkl",
    "initialize_distributed",
    "is_coordinator",
    "make_grid",
    "model_handoff",
    "model_row_sum",
    "psum_data",
    "psum_model",
    "run_grid",
    "scatter_add_model_shard",
    "scatter_add_model_shard_bkl",
]
