"""Input generators: the genome of a configuration
(``synth_genome``) and the reads of a traffic mix (one module per
``generator`` named in a traffic file, with ``make_batch``)."""
