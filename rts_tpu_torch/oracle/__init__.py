from rts_tpu_torch.oracle.tracer import OracleResult, generate_fan, trace_pulse

__all__ = ["OracleResult", "generate_fan", "trace_pulse"]
