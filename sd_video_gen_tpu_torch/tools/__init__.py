"""Tools of the port: the quality evidence (``quality_modes``,
``dpmpp_quality_gate``) and seeded SD weight files
(``synthetic_checkpoint``)."""
