from .planner import (ChannelPlan, PipelineSpec, SPHaloSpec, analyze_pipeline,
                      analyze_sp_halo, plan_report)

__all__ = ["ChannelPlan", "PipelineSpec", "SPHaloSpec", "analyze_pipeline",
           "analyze_sp_halo", "plan_report"]
