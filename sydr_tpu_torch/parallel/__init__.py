"""Multi-device execution on ``torch.distributed``: one process per
device (``distributed``), channel and Doppler sharding (``mesh``), time
sharding of a block (``timeshard``) and a dry run over N ranks
(``dryrun``)."""
