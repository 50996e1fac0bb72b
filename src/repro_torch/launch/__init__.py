"""Launchers and cost models on the port's card: the serving and training
launchers, the production meshes (`mesh`), the dry run (`dryrun`) over the
op-level cost walker (`hlo_stats`), and `roofline` (the dry-run report and
the DSE design-point predictor over the H100's constants in
`repro_torch.device`)."""
