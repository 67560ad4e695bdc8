"""Fine-tuning: BertAdam (:mod:`.optimization`) and the train step
(:mod:`.trainer`)."""
