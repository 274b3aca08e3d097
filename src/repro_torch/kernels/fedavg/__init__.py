"""fedavg kernel family: weighted aggregation of a flat client stack."""
