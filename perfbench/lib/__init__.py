"""The harness's yardstick: scene and weight generation, spans, the trace
reduction, the FLOP and byte counters, and the correctness comparison."""
