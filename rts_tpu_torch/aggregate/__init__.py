from rts_tpu_torch.aggregate.paths import LaneAggregate, aggregate_lanes

__all__ = ["LaneAggregate", "aggregate_lanes"]
