"""The sharded path: the rule tables (``sharding``), the activation
hints (``hints``), one device's share of a step and its exchanges
(``program``) over the dry-run's counting backend or ``torch.distributed``
(``comm``), the pipeline (``pipeline``), gradient compression
(``compression``) and fault tolerance for training fleets
(``fault_tolerance``)."""
