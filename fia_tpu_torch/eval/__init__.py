"""The paper's experiments: RQ1 (influence against leave-one-out
retraining, ``rq1``), RQ2 (the cost of a query, ``rq2``) and their
metrics."""
