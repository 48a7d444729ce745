"""SeqCDC chunking core: parameters, oracle, masks, automaton, public API."""
