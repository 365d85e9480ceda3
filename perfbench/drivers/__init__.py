"""One driver per kind of traffic; a mix file names its driver."""
