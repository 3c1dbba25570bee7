"""The multi-device layer: logical-axis sharding rules on a
``DeviceMesh`` (``sharding``) and the roofline terms of a traced step
(``hlo_analysis``)."""
