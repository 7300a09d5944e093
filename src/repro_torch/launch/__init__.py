"""Entry points of the port: ``launch.serve`` (LLM serving),
``launch.train`` (LM training), ``launch.train_gnn`` (LeapGNN training)
and ``launch.dryrun_gnn`` (the GNN pod dry run, over the meshes of
``launch.mesh`` with the census of ``launch.dryrun``)."""
