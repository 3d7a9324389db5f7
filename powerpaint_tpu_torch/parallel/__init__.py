"""Multi-process execution: the (data, model) mesh over ``torch.distributed``
(``mesh``), the collectives (``collectives``), the rank launcher
(``launch``) and the multi-process dry run (``dryrun``)."""
