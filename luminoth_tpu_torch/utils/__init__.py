"""Host utilities: activations, config, weights bridge, predictor."""
