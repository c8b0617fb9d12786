# Submodules are imported explicitly (repro_torch.parallel.sharding,
# .collectives, .pipeline), as the reference's are: importing one loads no
# torch.distributed machinery that it does not use.
