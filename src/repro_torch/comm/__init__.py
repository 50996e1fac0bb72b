from .channels import fifo_shift, reorder_buffer_read
from .group import DistGroup, LocalGroup, run_ranks
from .pipeline import (pipeline_loss_fn, pipeline_train_step, ring_lowering,
                       stage_params)
from .planner import (ChannelPlan, PipelineSpec, SPHaloSpec, analyze_pipeline,
                      analyze_sp_halo, plan_report)

__all__ = ["ChannelPlan", "DistGroup", "LocalGroup", "PipelineSpec",
           "SPHaloSpec", "analyze_pipeline", "analyze_sp_halo", "fifo_shift",
           "pipeline_loss_fn", "pipeline_train_step", "plan_report",
           "reorder_buffer_read", "ring_lowering", "run_ranks",
           "stage_params"]
