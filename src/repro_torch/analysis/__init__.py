"""Cost models of the dry-run: the analytic per-device model
(``analytic``) and the collectives a traced step issues (``comm``)."""
