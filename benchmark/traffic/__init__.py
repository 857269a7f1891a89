"""Traffic: the skies and the I/Q records a cell's runs process, made from
the run's seed (``scenario``) and synthesized on the card (``synth``)."""
