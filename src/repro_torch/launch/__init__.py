"""Cost models on the port's card (`roofline`: the DSE design-point
predictor over the H100's constants in `repro_torch.device`)."""
