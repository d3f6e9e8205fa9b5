"""The report labeller: a BERT classifier of radiology reports into the
pathology labels, its trainer and the sentence-shuffle augmentation."""
