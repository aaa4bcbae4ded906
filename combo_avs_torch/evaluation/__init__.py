"""Host-side evaluation: metrics, the S4 evaluator and postprocessing."""
