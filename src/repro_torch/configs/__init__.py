"""The paper's workload DAGs (``paper_models``)."""
